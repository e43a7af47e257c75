// K2: the scan shadows' readout (lighting/scan_shadows.py:scan_readout)
// for Hopper (sm_90a).
//
// Replaces the eager readout of the port's lighting/scan_shadows.py,
// `scan_readout_reference`, which stays as the plain version for CPU
// tensors, and through it the XLA stages of illuminant_tpu/lighting/
// scan_shadows.py:scan_visibility's readout (:581-839, with
// `_upsample_nominated` :842; the JAX package has no Pallas kernel for
// it). The eager readout makes ~200 full-size
// passes over the (L, H, W) readout grid, each reading and writing 33 MB
// at 16 lanes of 540 x 960: the sector select over K1's (4, C, L, nh, nw)
// carries, the mask-normalised 2x upsample of the nominated fields, the
// ray geometry, the refine's field evaluations, the compound-umbra guard
// and the thresholds. K2 is one launch a `scan_visibility` call.
//
// One block of 256 threads a (light, 8 x 32 tile of the readout grid),
// a thread a pixel. Stage 1: for the nomination-grid texels under the
// tile, with a one-texel edge-clamped halo, each thread of the block in
// turn reads the one sector its texel selects (3 or 6 channels of K1's
// output; the other three sectors are never read) and forms the fields
// `_upsample_nominated` upsamples: the no-blocker-clamped distance, the
// masked complements of the fractions, the mask, and (carried) the
// footprint minimum and the interval's ends. They go to shared memory,
// never to device memory. Each further halving is one more staged level
// (ping-pong buffers); the last is the thread's own, from the staged
// taps in `upsample2x_bilinear`'s order (rows, then columns; 0.75 x +
// 0.25 neighbour). Stage 2, in registers: the ray geometry, the refine at
// 0-3 candidates (the field at each: sdf_fields.cuh's AnalyticScene, its
// arrays staged in shared memory as K12 stages them or read from device
// memory, the SdfVolume's tap pack, the ColumnField's map pack, or the
// carried column reconstruction), the guard, the thresholds, the power;
// one 4-byte store. Instances: the field and whether the grid was halved
// (templates); candidates, per-lane heights and offsets, the trace
// budget at run time.
//
// What bounds it on an H100: the field evaluations. At the 2.5D cell's
// 16 lanes of 540 x 960 the bytes are ~64 MB (the selected sector's three
// channels ~25 MB, the heights and xy offsets ~6 MB from the L2 across
// lanes, the 33 MB output: ~19 us at 3.35 TB/s), the work one scene
// evaluation a point, 8.3 M of 4 primitives and 3 prisms of up to 6 edges
// (~1.5 kflop a point). The design keeps everything between K1's carries
// and the visibility in registers and shared memory: no intermediate
// tensor, one pass. On an H100 that readout takes 0.63 ms, 14% of its
// operation bound, and the flagship's 8 lanes of a 4-primitive scene
// 0.15 ms (PERF.md section 6): the field's divisions and roots, kept for
// bit-equality, and the lanes' divergent candidates hold it there.
//
// Rounding: the visibility must equal the eager readout's on the card bit
// for bit (a uint8 level off fails the 2.5D cell). The file is compiled
// with -fmad=false; every operation is the plain version's, in its order;
// division and sqrtf are IEEE. torch's forms on the card are kept where
// they differ from the expression's face: a tensor divided by a Python
// scalar is a multiplication by the scalar's float32 reciprocal (the
// threshold's range: the wrapper passes it), `1.5 / t` is
// `t.reciprocal() * 1.5` (Tensor.__rtruediv__), min, max and clamp
// propagate NaN as torch's do, and the power is torch.pow's for the
// exponents it special-cases.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sdf_fields.cuh"

namespace {

using namespace illum_fields;

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;
// A staged level's rows and columns, halo included: the wrapper's plan
// checks that every level of every tile fits.
constexpr int kRegionY = kTileY / 2 + 4;
constexpr int kRegionX = kTileX / 2 + 4;
constexpr int kRegion = kRegionY * kRegionX;
constexpr int kMaxHalvings = 8;
// The AnalyticScene's arrays go to shared memory up to this size.
constexpr int kAnalyticSmemMax = 48 * 1024;

// The field instances: K12's (cone_trace.cu's Instance enum) and two of
// the readout's own.
enum Instance {
  kVolume = 0,
  kAnalytic = 1,
  kColumn = 2,
  kAnalyticGlobal = 3,
  kCarried = 4,  // the carried column reconstruction, no field read
  kNoField = 5   // the flatland (no candidate) or no scene (distance 128)
};

// The upsampled channels: the masked complements of k and exit, the
// clamped distance, the mask; carried, the masked footprint minimum and
// the interval's ends (upsampled edge-aware).
constexpr int kKc = 0, kEc = 1, kD = 2, kW = 3, kFm = 4, kTop = 5, kBot = 6;

struct Params {
  const float* walk;       // (4, C, L, nh, nw)
  // The lanes' arrays, each with its element stride a lane (`stride`):
  const float* lx_n;       // (L,) lights on the nomination grid
  const float* ly_n;
  const float* light;      // (L, 3) world, x y z a stride.light_c apart
  const float* radius;     // (L,)
  const float* ramp;       // (L,)
  const float* max_trace;  // (L,) or null
  const float* trace_z;    // 0-d
  const float* offset;     // (2,) world offset of a window, or null
  const float* pixel_z;    // (H, W) or (L, H, W), or null
  const float* offset_xy;  // (H, W, 2) or (L, H, W, 2), or null
  float* out;              // (L, H, W)
  int channels, lights, nh, nw, height, width, halvings, candidates;
  int pz_per_light, oxy_per_light, pow_mode;
  struct {
    int lx_n, ly_n, light, light_c, radius, ramp, max_trace;
  } stride;
  float render_scale, inv_rs, inv_rs2, max_cone_radius, cone_growth, power,
      inv_range, min_cone_radius, hack, fully, top_fill, bot_fill;
};

// torch.minimum / maximum / clamp on CUDA floats (NaN propagates).
__device__ __forceinline__ float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float t_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float t_clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}

__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// final ** power as torch.pow(tensor, scalar) computes it on the card:
// the wrapper's mode says which of its special cases the exponent is.
__device__ __forceinline__ float scalar_pow(float x, int mode, float p) {
  switch (mode) {
    case 0:
      return 1.0f;  // ** 0: a fill
    case 1:
      return x;  // ** 1: a copy
    case 2:
      return sqrtf(x);
    case 3:
      return x * x;
    case 4:
      return x * x * x;
    case 5:
      return 1.0f / x;
    case 6:
      return (float)(1.0 / (double)(x * x));
    case 7:
      return rsqrtf(x);
    default:
      return powf(x, p);
  }
}

// One nomination-grid texel: the selected sector's carries (d, k, neg_k
// and, carried, f_min, h_top, h_bot) and the fractions, as the plain
// version's sector select forms them.
struct Nominated {
  float min_d, k_frac, exit_frac;
  float tb[3];
};

template <bool kCarry>
__device__ __forceinline__ Nominated nominated(const Params& p, int l,
                                               int y, int x, float lxn,
                                               float lyn) {
  const float dxn = ((float)x + 0.5f) - lxn;
  const float dyn = ((float)y + 0.5f) - lyn;
  const float adx = fabsf(dxn), ady = fabsf(dyn);
  const bool horiz = adx >= ady;
  // E/W own |dy| <= |dx|, N/S the rest.
  const int sector = (horiz && dxn >= 0.0f)  ? 0
                     : (horiz && dxn < 0.0f) ? 1
                     : (!horiz && dyn >= 0.0f) ? 2
                                               : 3;
  const int plane = p.nh * p.nw;
  const int cs = p.lights * plane;  // a channel's stride
  const float* w = p.walk + (sector * p.channels * p.lights + l) * plane +
                   y * p.nw + x;
  Nominated n;
  n.min_d = __ldg(w);
  const float min_k = __ldg(w + cs);
  const float neg_k = __ldg(w + 2 * cs);
  if (kCarry) {
#pragma unroll
    for (int i = 0; i < 3; ++i) n.tb[i] = __ldg(w + (3 + i) * cs);
  }
  const float major_n = t_clamp_min(t_max(adx, ady), 1e-3f);
  n.k_frac = t_clamp(min_k / major_n, 0.0f, 1.0f);
  n.exit_frac = t_clamp(t_max(neg_k, min_k) / major_n, 0.0f, 1.0f);
  return n;
}

// A level's staged rectangle: rows [y0, y0 + ny), columns [x0, x0 + nx).
struct Region {
  int y0, x0, ny, nx;
};

// The texels of level k (of h) under a tile of the readout level: from
// the tile's pixels down, each level the texels under the one above and
// an edge-clamped neighbour each side. Recomputed where needed, so the
// kernel keeps no array of regions (a dynamically indexed array lives in
// local memory).
__device__ __forceinline__ Region region_at(const Params& p, int Y0, int X0,
                                            int k) {
  int lo_y = Y0, hi_y = min(Y0 + kTileY, p.height) - 1;
  int lo_x = X0, hi_x = min(X0 + kTileX, p.width) - 1;
  for (int j = p.halvings - 1; j >= k; --j) {
    lo_y = max((lo_y >> 1) - 1, 0);
    hi_y = min((hi_y >> 1) + 1, (p.nh << j) - 1);
    lo_x = max((lo_x >> 1) - 1, 0);
    hi_x = min((hi_x >> 1) + 1, (p.nw << j) - 1);
  }
  return Region{lo_y, lo_x, hi_y - lo_y + 1, hi_x - lo_x + 1};
}

// `upsample2x_bilinear`'s value at (Y, X) of the level above `c`, whose
// level is (ry, rx) large and staged at `reg`: the row pass (Y's texel
// and its neighbour, edge-clamped), then the column pass, 0.75 x + 0.25
// neighbour each. `nn` is the nearest texel's value (the edge-aware
// extras' other choice).
__device__ __forceinline__ float up2(const float* c, const Region& reg,
                                     int ry, int rx, int Y, int X,
                                     float* nn) {
  const int i = Y >> 1;
  const int j = (Y & 1) ? min(i + 1, ry - 1) : max(i - 1, 0);
  const int a = X >> 1;
  const int b = (X & 1) ? min(a + 1, rx - 1) : max(a - 1, 0);
  const float* ci = c + (i - reg.y0) * kRegionX - reg.x0;
  const float* cj = c + (j - reg.y0) * kRegionX - reg.x0;
  const float ra = 0.75f * ci[a] + 0.25f * cj[a];
  const float rb = 0.75f * ci[b] + 0.25f * cj[b];
  *nn = ci[a];
  return 0.75f * ra + 0.25f * rb;
}

// Every channel of level k's texel (Y, X) from the staged level k - 1.
template <int NCH>
__device__ __forceinline__ void up_texel(const float* src, const Region& reg,
                                         int ry, int rx, int Y, int X,
                                         float* v) {
  float nn;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const float bi = up2(src + ch * kRegion, reg, ry, rx, Y, X, &nn);
    // The interval's ends: bilinear where the neighbourhood agrees
    // within 2 units, nearest across blocker boundaries.
    v[ch] = (ch < kTop || fabsf(bi - nn) < 2.0f) ? bi : nn;
  }
}

template <int F, bool kUp>
__global__ void __launch_bounds__(kThreads)
    scan_readout_kernel(const Params p, const FieldTable f) {
  constexpr bool kCarry = F == kCarried;
  constexpr int NCH = kCarry ? 7 : 4;
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int l = blockIdx.z;
  const int tid = threadIdx.x;
  const int Y0 = blockIdx.y * kTileY;
  const int X0 = blockIdx.x * kTileX;
  const int Y = Y0 + tid / kTileX;
  const int X = X0 + tid % kTileX;

  Analytic scene = f.analytic;
  float* levels = smem;
  if (F == kAnalytic) {
    scene = stage_analytic(f.analytic, smem, kThreads);
    levels = smem + ((analytic_floats(f.analytic) + 3) & ~3);
  }
  const float lxn = __ldg(p.lx_n + l * p.stride.lx_n);
  const float lyn = __ldg(p.ly_n + l * p.stride.ly_n);

  float min_d, k_frac, exit_frac, tb[3];
  bool has_blocker;
  if (kUp) {
    // The staged levels 0 .. h - 1 of this tile. Level 0: the nominated
    // fields of the selected sector.
    const int h = p.halvings;
    {
      const Region r0 = region_at(p, Y0, X0, 0);
      float* dst = levels;
      for (int i = tid; i < r0.ny * r0.nx; i += kThreads) {
        const int ry = i / r0.nx, rx = i - ry * r0.nx;
        const Nominated n =
            nominated<kCarry>(p, l, r0.y0 + ry, r0.x0 + rx, lxn, lyn);
        const bool nom = n.min_d < 4096.0f;
        float v[7];
        v[kKc] = nom ? 1.0f - n.k_frac : 0.0f;
        v[kEc] = nom ? 1.0f - n.exit_frac : 0.0f;
        v[kD] = t_clamp_max(n.min_d, 8192.0f);
        v[kW] = nom ? 1.0f : 0.0f;
        if (kCarry) {
          v[kFm] = nom ? t_clamp_max(n.tb[0], 4096.0f) : 0.0f;
          v[kTop] = nom ? n.tb[1] : p.top_fill;
          v[kBot] = nom ? n.tb[2] : p.bot_fill;
        }
        const int at = ry * kRegionX + rx;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) dst[ch * kRegion + at] = v[ch];
      }
    }
    __syncthreads();
    // Levels 1 .. h - 1, each from the one below (ping-pong).
    for (int k = 1; k < h; ++k) {
      const float* src = levels + ((k - 1) & 1) * NCH * kRegion;
      float* dst = levels + (k & 1) * NCH * kRegion;
      const Region rs = region_at(p, Y0, X0, k - 1);
      const Region rd = region_at(p, Y0, X0, k);
      const int ry = p.nh << (k - 1), rx = p.nw << (k - 1);
      for (int i = tid; i < rd.ny * rd.nx; i += kThreads) {
        const int dy = i / rd.nx, dx = i - dy * rd.nx;
        float v[NCH];
        up_texel<NCH>(src, rs, ry, rx, rd.y0 + dy, rd.x0 + dx, v);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
          dst[ch * kRegion + dy * kRegionX + dx] = v[ch];
      }
      __syncthreads();
    }
    if (Y >= p.height || X >= p.width) return;
    float v[NCH];
    up_texel<NCH>(levels + ((h - 1) & 1) * NCH * kRegion,
                  region_at(p, Y0, X0, h - 1), p.nh << (h - 1),
                  p.nw << (h - 1), Y, X, v);
    // The mask-normalised fractions (`_upsample_nominated`'s tail).
    has_blocker = v[kD] < 4096.0f;
    const float wgt = t_clamp_min(v[kW], 1e-3f);
    min_d = v[kD];
    k_frac = t_clamp(1.0f - v[kKc] / wgt, 0.0f, 1.0f);
    exit_frac = t_clamp(1.0f - v[kEc] / wgt, 0.0f, 1.0f);
    if (kCarry) {
      tb[0] = v[kFm] / wgt;
      tb[1] = v[kTop];
      tb[2] = v[kBot];
    }
  } else {
    if (Y >= p.height || X >= p.width) return;
    const Nominated n = nominated<kCarry>(p, l, Y, X, lxn, lyn);
    min_d = n.min_d;
    k_frac = n.k_frac;
    exit_frac = n.exit_frac;
    has_blocker = min_d < 1e8f;
    if (kCarry) {
#pragma unroll
      for (int i = 0; i < 3; ++i) tb[i] = n.tb[i];
    }
  }

  // --- The readout at full shadow resolution (pixel centres at i + 0.5).
  const float off_x = p.offset ? __ldg(p.offset) : 0.0f;
  const float off_y = p.offset ? __ldg(p.offset + 1) : 0.0f;
  const float* light = p.light + l * p.stride.light;
  const float lx_w = __ldg(light);
  const float ly_w = __ldg(light + p.stride.light_c);
  const float lz = __ldg(light + 2 * p.stride.light_c);
  const float lx = (lx_w - off_x) * p.render_scale;
  const float ly = (ly_w - off_y) * p.render_scale;
  const float xs = (float)X + 0.5f;
  const float ys = (float)Y + 0.5f;
  const float dx = xs - lx;
  const float dy = ys - ly;
  const float major = t_clamp_min(t_max(fabsf(dx), fabsf(dy)), 1e-3f);
  const int pix = Y * p.width + X;
  const int lpix = l * p.height * p.width + pix;
  const float pz =
      p.pixel_z ? __ldg(p.pixel_z + (p.pz_per_light ? lpix : pix)) : 0.0f;
  const float dz = pz - lz;
  const float ray_len_w = sqrtf((dx * dx + dy * dy) * p.inv_rs2 + dz * dz);
  const float sec = ray_len_w / major;

  // createTraceConfig (ConeTrace.fxh:122-139) + coneTraceStep (:51-71).
  const float max_radius =
      t_clamp(__ldg(p.radius + l * p.stride.radius), p.min_cone_radius,
              p.max_cone_radius);
  const float ramp = t_clamp_min(__ldg(p.ramp + l * p.stride.ramp), 16.0f);
  const float growth = max_radius / ramp * p.cone_growth;

  // The exact refine's ray endpoints: the light -> the lifted surface.
  float px_x = xs * p.inv_rs + off_x;
  float px_y = ys * p.inv_rs + off_y;
  if (p.offset_xy) {
    const float* o = p.offset_xy + 2 * (p.oxy_per_light ? lpix : pix);
    px_x = px_x + __ldg(o);
    px_y = px_y + __ldg(o + 1);
  }
  if (p.max_trace) {
    const float u_blocker =
        t_clamp_min((1.0f - k_frac) * major * sec, 0.0f);
    has_blocker = has_blocker &&
                  (u_blocker <= __ldg(p.max_trace + l * p.stride.max_trace));
  }

  float vis;
  if (p.candidates <= 0) {
    // Pure flatland: the scan's own 2D minimum.
    const float u0 = t_clamp_min((1.0f - k_frac) * major * sec, 0.0f);
    const float radius0 = t_min(growth * u0 + p.min_cone_radius, max_radius);
    vis = t_clamp_max((min_d + p.hack) / radius0, 1.0f);
    if (p.max_trace) vis = has_blocker ? vis : 1.0f;
  } else {
    // Refine candidates along the blocker span.
    const float fwd = t_min((exit_frac - k_frac) * 0.5f,
                            (1.0f / (major * sec)) * 1.5f);
    const float t_star = min_d < -1.0f ? k_frac + fwd
                                       : (k_frac + exit_frac) * 0.5f;
    // The candidates: t_star; then the exit (2), or the entry and the
    // exit (3).
    const float t_entry =
        min_d < -1.0f ? (k_frac + exit_frac) * 0.5f : k_frac;
    const int n_cand = min(p.candidates, 3);
    float max_valid_z = 0.0f;
    if (F == kVolume) max_valid_z = __ldg(f.volume.max_valid_z);
    vis = 1.0f;
    for (int c = 0; c < n_cand; ++c) {
      const float t = c == 0 ? t_star
                      : c == n_cand - 1 ? exit_frac
                                        : t_entry;
      const float sz = lz + (pz - lz) * t;
      float d_i;
      if (F == kCarried) {
        // columns.reconstruct_profile at the candidate's height.
        const float below = tb[2] - sz;
        const float above = sz - tb[1];
        const float dzc = t_max(below, above);
        const float f_pos = t_clamp_min(tb[0], 0.0f);
        const float dz_pos = t_clamp_min(dzc, 0.0f);
        const float outside = sqrtf(f_pos * f_pos + dz_pos * dz_pos);
        d_i = t_clamp_max(t_max(tb[0], dzc), 0.0f) + outside;
      } else if (F == kNoField) {
        d_i = 128.0f;
      } else {
        const float qx = lx_w + (px_x - lx_w) * t;
        const float qy = ly_w + (px_y - ly_w) * t;
        if (F == kVolume)
          d_i = volume_distance(f.volume, max_valid_z, qx, qy, sz);
        else if (F == kAnalytic)
          d_i = analytic_distance<true>(scene, qx, qy, sz);
        else if (F == kAnalyticGlobal)
          d_i = analytic_distance<false>(scene, qx, qy, sz);
        else
          d_i = column_distance(f.column, qx, qy, sz);
      }
      const float u_i = t_clamp_min((1.0f - t) * major * sec, 0.0f);
      const float radius_i =
          t_min(growth * u_i + p.min_cone_radius, max_radius);
      const float vis_i = (d_i + p.hack) / radius_i;
      vis = t_min(vis, has_blocker ? vis_i : 1.0f);
    }
    // The compound-umbra guard: where the 3D ray at the nominated blocker
    // is at or below the trace plane, the flatland block applies.
    const float tz = __ldg(p.trace_z) + 0.5f;
    const float ray_z_at_k = lz + (pz - lz) * k_frac;
    const float ray_z_at_exit = lz + (pz - lz) * exit_frac;
    const bool low_ray = (ray_z_at_k <= tz) ||
                         ((ray_z_at_exit <= tz) && (min_d < -0.5f));
    const float u0 = t_clamp_min((1.0f - k_frac) * major * sec, 0.0f);
    const float radius0 = t_min(growth * u0 + p.min_cone_radius, max_radius);
    const float flat_vis = t_clamp_max((min_d + p.hack) / radius0, 1.0f);
    vis = (has_blocker && low_ray) ? t_min(vis, flat_vis) : vis;
  }
  const float final_ =
      t_clamp(t_clamp(vis - p.fully, 0.0f, 1.0f) * p.inv_range, 0.0f, 1.0f);
  p.out[lpix] = scalar_pow(final_, p.pow_mode, p.power);
}

typedef void (*Kernel)(const Params, const FieldTable);

template <int F>
Kernel pick(bool up) {
  return up ? scan_readout_kernel<F, true> : scan_readout_kernel<F, false>;
}

// The instance's kernel: `instance` is the field instance times 2, plus 1
// where the grid was halved.
Kernel kernel_for(int instance) {
  const bool up = (instance & 1) != 0;
  switch (instance >> 1) {
    case kVolume:
      return pick<kVolume>(up);
    case kAnalytic:
      return pick<kAnalytic>(up);
    case kColumn:
      return pick<kColumn>(up);
    case kAnalyticGlobal:
      return pick<kAnalyticGlobal>(up);
    case kCarried:
      return pick<kCarried>(up);
    case kNoField:
      return pick<kNoField>(up);
    default:
      return nullptr;
  }
}

cudaError_t opt_in(Kernel fn, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// ptrs: walk, lx_n, ly_n, light, radius, ramp, max_trace (or null),
//       trace_z, offset (or null), pixel_z (or null), offset_xy (or null),
//       out, then the field's (cone_trace.cu's order).
// ints: channels, lights, nh, nw, height, width, halvings, candidates,
//       pz_per_light, oxy_per_light, pow_mode, smem bytes, the lane
//       strides (lx_n, ly_n, light, light's component, radius, ramp,
//       max_trace), field kind (-1: none), then the field's ints.
// floats: render_scale, inv_rs, inv_rs2, max_cone_radius, cone_growth,
//       power, inv_range, min_cone_radius, hack, fully, top_fill,
//       bot_fill, then the field's floats.
// `instance`: the field instance (the Instance enum) times 2, plus 1 for
// a halved grid.
extern "C" int scan_readout(const void* const* ptrs, const long long* ints,
                            const float* floats, int instance,
                            void* stream) {
  Params p;
  p.walk = (const float*)ptrs[0];
  p.lx_n = (const float*)ptrs[1];
  p.ly_n = (const float*)ptrs[2];
  p.light = (const float*)ptrs[3];
  p.radius = (const float*)ptrs[4];
  p.ramp = (const float*)ptrs[5];
  p.max_trace = (const float*)ptrs[6];
  p.trace_z = (const float*)ptrs[7];
  p.offset = (const float*)ptrs[8];
  p.pixel_z = (const float*)ptrs[9];
  p.offset_xy = (const float*)ptrs[10];
  p.out = (float*)ptrs[11];
  p.channels = (int)ints[0];
  p.lights = (int)ints[1];
  p.nh = (int)ints[2];
  p.nw = (int)ints[3];
  p.height = (int)ints[4];
  p.width = (int)ints[5];
  p.halvings = (int)ints[6];
  p.candidates = (int)ints[7];
  p.pz_per_light = (int)ints[8];
  p.oxy_per_light = (int)ints[9];
  p.pow_mode = (int)ints[10];
  const int smem = (int)ints[11];
  p.stride.lx_n = (int)ints[12];
  p.stride.ly_n = (int)ints[13];
  p.stride.light = (int)ints[14];
  p.stride.light_c = (int)ints[15];
  p.stride.radius = (int)ints[16];
  p.stride.ramp = (int)ints[17];
  p.stride.max_trace = (int)ints[18];
  const int kind = (int)ints[19];
  p.render_scale = floats[0];
  p.inv_rs = floats[1];
  p.inv_rs2 = floats[2];
  p.max_cone_radius = floats[3];
  p.cone_growth = floats[4];
  p.power = floats[5];
  p.inv_range = floats[6];
  p.min_cone_radius = floats[7];
  p.hack = floats[8];
  p.fully = floats[9];
  p.top_fill = floats[10];
  p.bot_fill = floats[11];
  FieldTable f = {};
  if (kind >= 0 && !fields_from(kind, ints + 20, floats + 12, ptrs + 12, &f))
    return (int)cudaErrorInvalidValue;
  const bool up = (instance & 1) != 0;
  if (up != (p.halvings > 0) || p.halvings > kMaxHalvings ||
      (p.nh << p.halvings) != p.height || (p.nw << p.halvings) != p.width)
    return (int)cudaErrorInvalidValue;
  if (p.lights <= 0 || p.height <= 0 || p.width <= 0) return 0;
  Kernel fn = kernel_for(instance);
  if (fn == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.width + kTileX - 1) / kTileX,
                  (p.height + kTileY - 1) / kTileY, p.lights);
  fn<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p, f);
  return (int)cudaGetLastError();
}

// An instance on the current card with `smem` bytes of shared memory:
// threads, registers and spilled (local) bytes a thread, resident blocks
// an SM.
extern "C" int scan_readout_plan(int instance, int smem, int* out) {
  Kernel fn = kernel_for(instance);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(fn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, (const void*)fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = blocks;
  return 0;
}
