// Tiled particle lights for Hopper (sm_90a): K10, one fused launch a frame.
//
// Replaces the device work of illuminant_tpu/lighting/tiled_lights.py:
// accumulate_sphere_lights_tiled (:123): the tile y bounds (:138-144), the
// binning bin_lights_to_tiles (:43; candidate offsets, a stable sort by
// tile, a searchsorted and the gathers), the per-light records, the AO and
// fullbright factor (:284, through the ColumnField's column-map sample,
// the Pallas kernel columns_pallas.py:78) and the shading (:229-291, a
// bfloat16 einsum of (T, 8, tile, tile) opacity planes with the lights'
// colours over a padded, tiled frame). Here one block takes one screen
// tile and does all of it:
//   a. the tile's shaded-world y bounds: a block min / max of relative_y
//      over the tile, a partial edge tile counting 0 for its pad pixels as
//      the plain version's zero pad does; the relief beyond the candidate
//      window goes to `window_deficit_px` by an atomicMax on the bits of
//      the non-negative clamped value;
//   b. the cull: every light against this tile by the plain binning's test
//      in its operation order (floor(x / tile), the offset inside the
//      +-reps window, the clamped distance to the tile's box, live). A
//      light has at most one candidate a tile, so the stable sort's order
//      is (offset index, light index): a first pass counts the survivors
//      of each offset, a prefix over the offsets gives each its first
//      slot, and a second pass compacts each chunk of lights in light
//      order (ballot and popc) and files them at their slots; the first
//      `capacity` are kept and the rest counted into `dropped`;
//   c. the per-pixel factor: fullbright discard x AO, the AO sample being
//      the ColumnField's distance query (column_query.cuh, the device
//      function of column_query) at the pixel's AO point. For any other
//      volume the route computes the factor in PyTorch and passes it in
//      (mode kPixF); without AO the kernel reads fullbright alone
//      (kFullbright);
//   d. the shading: the kept records are staged once in shared memory
//      (two float4 a slot). Each warp shades sub-tiles of 32 columns x 2
//      rows, a thread one column's 2 pixels with the sums in registers.
//      For each sub-tile the warp first filters the kept slots, 32 at a
//      time by ballot, to those whose support reaches the sub-tile's world
//      box (its own min / max of x, y + relative_y and z), and walks the
//      survivors in slot order, so each pixel's sum runs in the plain
//      version's order.
//
// What bounds it on an H100: at the particle-light cell (1080p, 2048
// lights of 38.5 px support, 64-px tiles) each tile bins ~19 lights but a
// pixel lies inside the support of ~4.6, so ~3/4 of the binned (light,
// pixel) pairs have opacity exactly 0. The first K10 evaluated them all
// (issue-bound, ~80 instructions a pair) and the route around it was ~470
// small launches a frame, paced by the host. Now the route is three
// launches (the map pack, the zeroing of the two diagnostics, K10), the
// sub-tile filter keeps ~7 lights a 32 x 2 sub-tile, and the per-pair
// arithmetic has no division and no libm call: the reciprocal square root
// of the squared distance gives the distance and divides the normal's
// dot product, 1 / ramp_length and 1 / 0.15 are precomputed, and the
// normal ramp's x ** 0.85 is exp2(0.85 * log2(x)) on the hardware's
// approximate lg2 / ex2 (x = 0 gives 0). Two rows a thread keep it at 64
// registers, four blocks an SM, all 510 blocks of the cell in one wave
// (four rows took 96 registers and two blocks an SM). The bound is the
// bytes: the G-buffer read and the image written once, ~84 MB.
//
// The skip is exact: it drops a pair only where the plain version's
// opacity is exactly +0. The box test's lower bound on the distance,
// sqrt(ex^2 + ey^2 + ez^2) with ex, ey (times the y squash), ez the
// box's distances to the light, forms its squared distance with the same
// roundings as the plain version's, each of them monotone, so the plain
// distance is at least the bound less a few ulps of the root. A pair is
// dropped only if the bound exceeds the support (radius + ramp_length for
// ramp modes 0 and 1, radius + 1 for mode 2) by a relative 2^-12
// (`cutoff`, from the wrapper), far beyond what those ulps and the
// rounding of (distance - radius) / ramp_length can cross: there the
// distance factor is 0 and the radius term saturate(radius - distance) is
// 0, so the opacity is 0 whatever the normal factor and the light
// occlusion (which only lowers the distance factor). Skipping a +0 term
// of a sum is exact.
//
// No tensor cores: the JAX package contracts the opacities with 4 colour
// channels on the MXU because the TPU has no other fast path. Here that
// product's N is 4, below the 8-wide minimum of an mma, and the work is
// the opacity itself; the sum is float32 on the CUDA cores.
//
// Rounding: the file is compiled with -fmad=false and follows the plain
// version's operation order (lighting/tiled_lights_kernel.py:
// tiled_lights_fused_reference; the shading
// tiled_light_accumulate_reference). The bins, `dropped` and the window
// deficit equal the plain version's exactly (integer and float32 compare
// and min / max only), and so does the AO sample (column_query.cuh
// matches columns.query_reference). The image is held to 1e-5 x (1 + its
// largest value), not to bit equality: rsqrtf and lg2 / ex2 are the
// hardware's approximations (2 ulp or so) where the plain version's
// torch.rsqrt, log2 and exp2 round otherwise; a few ulps of one light's
// opacity are far below the bound.
//
// The wrapper (tiled_lights_kernel.tiled_lights_fused) checks the sizes
// before it calls in.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "column_query.cuh"

namespace {

using namespace illum_columns;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;  // a thread's pixels: one column, 2 rows
constexpr int kStaticSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// Where the per-pixel factor comes from.
enum FactorMode { kPixF = 0, kFullbright = 1, kColumnAo = 2 };

struct Params {
  int height, width, tile, tiles_x;
  int n_lights, pos_stride, capacity;
  int reps_x, reps_y, offsets;
  int ramp_mode, with_alpha, factor_mode;
  float render_scale;
  float inf_x, inf_y, extra_y;  // binning, px
  float radius, inv_ramp, y_factor, cutoff;
  float tcolor[4];
  float weight;  // template opacity x brightness scale
  float ao_radius, ao_opacity, ao_keep;  // ao_keep = 1 - ao_opacity
  int hc, wc;
  Geometry geo;
};

struct Inputs {
  const float* z;
  const float* relative_y;
  const float* normal;
  const float* factor;  // fullbright (kFullbright, kColumnAo) or pix_f
  const float* position;
  const float* color;
  const uint8_t* active;
  const float* light_occlusion;
  const float* pack;  // kColumnAo: the 5-map quad pack
  float* out;
  int* diag;  // [dropped, bits of window_deficit_px]
  int* dbg_idx;  // optional (T, capacity) kept lists
  int* dbg_count;  // optional (T,) kept counts
};

__device__ __forceinline__ float saturate(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// The hardware's approximate base-2 logarithm and power (MUFU; log2(0)
// = -inf, exp2(-inf) = 0, so x ** 0.85 is 0 at x = 0 as in the plain
// version).
__device__ __forceinline__ float fast_log2(float x) {
  float r;
  asm("lg2.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// bin_lights_to_tiles' test of light i against tile (tx, ty) with y
// bounds [ylo, yhi], in its operation order -> the candidate's offset
// index (oy-major, then ox), or -1.
__device__ __forceinline__ int candidate(const Params& p, const Inputs& in,
                                         int i, int tx, int ty, float ylo,
                                         float yhi) {
  if (!in.active[i]) return -1;
  const float* pos = in.position + (long long)i * p.pos_stride;
  const float x = pos[0] * p.render_scale;
  const float y = pos[1] * p.render_scale;
  const float tile = (float)p.tile;
  const long long ox = (long long)tx - __float2int_rd(x / tile);
  const long long oy = (long long)ty - __float2int_rd(y / tile);
  if (ox < -p.reps_x || ox > p.reps_x || oy < -p.reps_y || oy > p.reps_y)
    return -1;
  const float x0 = (float)(tx * p.tile);
  const float dx = x - fminf(fmaxf(x, x0), x0 + tile);
  const float dy = y - fminf(fmaxf(y, ylo), yhi);
  if (!(fabsf(dx) <= p.inf_x && fabsf(dy) <= p.inf_y)) return -1;
  return (int)((oy + p.reps_y) * (2 * p.reps_x + 1) + (ox + p.reps_x));
}

struct Box {
  float x0, x1, y0, y1, z0, z1;
};

// False only where no pixel of the box can get a nonzero opacity from
// the light at a (see the header).
__device__ __forceinline__ bool reaches(const float4& a, const Box& b,
                                        const Params& p) {
  const float ex = fmaxf(fmaxf(b.x0 - a.x, a.x - b.x1), 0.0f);
  const float ey =
      fmaxf(fmaxf(b.y0 - a.y, a.y - b.y1), 0.0f) * p.y_factor;
  const float ez = fmaxf(fmaxf(b.z0 - a.z, a.z - b.z1), 0.0f);
  return !(sqrtf(ex * ex + ey * ey + ez * ez) > p.cutoff);
}

// The fullbright discard x AO factor of one pixel (tiled_lights.py's
// epilogue, AOCommon.fxh:1-20) at world (wx, wy, wz) with normal z nz.
__device__ __forceinline__ float pixel_factor(const Params& p,
                                              const Inputs& in, long long i,
                                              float wx, float wy, float wz,
                                              float nz) {
  const float v = in.factor[i];
  if (p.factor_mode == kPixF) return v;
  float f = v < 0.5f ? 1.0f : 0.0f;
  if (p.factor_mode == kColumnAo) {
    const float ao_r = p.ao_radius * fmaxf(nz, 0.0f);
    if (ao_r >= 0.5f) {
      const float d = column_distance(in.pack, p.hc, p.wc, p.geo, wx, wy,
                                      wz + nz * ao_r);
      const float clamped = fminf(fmaxf(d, 0.0f), ao_r);
      float r = 1.0f - saturate(clamped / fmaxf(ao_r, 1e-6f));
      r = 1.0f - r * r;
      f = f * (p.ao_keep + r * p.ao_opacity);
    }
  }
  return f;
}

__global__ void __launch_bounds__(kThreads)
tiled_lights_kernel(Inputs in, Params p) {
  extern __shared__ float4 recs[];  // 2 float4 a kept slot
  int* kept = reinterpret_cast<int*>(recs + 2 * p.capacity);
  int* cnt = kept + p.capacity;  // survivors of each offset
  int* first = cnt + p.offsets;  // each offset's first slot
  int* run = first + p.offsets;  // each offset's survivors filed so far
  int* list = run + p.offsets;   // a chunk's survivors, in light order
  int* list_o = list + kThreads;
  __shared__ float red[3][kWarps];
  __shared__ int warp_n[kWarps];
  __shared__ int total_s;

  const int t = blockIdx.x;
  const int ty = t / p.tiles_x;
  const int tx = t - ty * p.tiles_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gy0 = ty * p.tile;
  const int gx0 = tx * p.tile;

  // a. The tile's relative_y range; a partial tile's pad pixels are 0.
  const bool partial = gy0 + p.tile > p.height || gx0 + p.tile > p.width;
  float mn = partial ? 0.0f : INFINITY;
  float mx = partial ? 0.0f : -INFINITY;
  float ma = 0.0f;
  const int pixels = p.tile * p.tile;
  for (int q = threadIdx.x; q < pixels; q += kThreads) {
    const int py = q / p.tile;
    const int gy = gy0 + py;
    const int gx = gx0 + (q - py * p.tile);
    if (gy < p.height && gx < p.width) {
      const float v = in.relative_y[(long long)gy * p.width + gx];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      ma = fmaxf(ma, fabsf(v));
    }
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  ma = warp_max(ma);
  if (lane == 0) {
    red[0][warp] = mn;
    red[1][warp] = mx;
    red[2][warp] = ma;
  }
  for (int o = threadIdx.x; o < p.offsets; o += kThreads) {
    cnt[o] = 0;
    run[o] = 0;
  }
  __syncthreads();
  mn = red[0][0];
  mx = red[1][0];
  ma = red[2][0];
  for (int w = 1; w < kWarps; ++w) {
    mn = fminf(mn, red[0][w]);
    mx = fmaxf(mx, red[1][w]);
    ma = fmaxf(ma, red[2][w]);
  }
  const float ty0 = (float)gy0;
  const float ylo = ty0 + mn * p.render_scale;
  const float yhi = (ty0 + (float)p.tile) + mx * p.render_scale;
  if (threadIdx.x == 0) {
    // max over tiles of max(m * rs - extra, 0) is that of the frame's m:
    // the clamp is monotone. Non-negative floats order as their bits.
    const float deficit = ma * p.render_scale - p.extra_y;
    if (deficit > 0.0f) atomicMax(in.diag + 1, __float_as_int(deficit));
  }

  // b. The cull: count each offset's survivors, then file them in order.
  for (int c0 = 0; c0 < p.n_lights; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    if (i < p.n_lights) {
      const int o = candidate(p, in, i, tx, ty, ylo, yhi);
      if (o >= 0) atomicAdd(cnt + o, 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int o = 0; o < p.offsets; ++o) {
      first[o] = s;
      s += cnt[o];
    }
    total_s = s;
    if (s > p.capacity) atomicAdd(in.diag, s - p.capacity);
  }
  __syncthreads();
  const int total = total_s;
  const int n_kept = min(total, p.capacity);
  for (int c0 = 0; total > 0 && c0 < p.n_lights; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    int o = -1;
    if (i < p.n_lights) {
      o = candidate(p, in, i, tx, ty, ylo, yhi);
      if (o >= 0 && first[o] >= p.capacity) o = -1;  // dropped whole
    }
    const unsigned ballot = __ballot_sync(kFull, o >= 0);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, n = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_n[w];
      if (w < warp) base += c;
      n += c;
    }
    if (o >= 0) {
      const int e = base + __popc(ballot & ((1u << lane) - 1u));
      list[e] = i;
      list_o[e] = o;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int e = 0; e < n; ++e) {
        const int oe = list_o[e];
        const int slot = first[oe] + run[oe];
        run[oe] += 1;
        if (slot < p.capacity) kept[slot] = list[e];
      }
    }
    __syncthreads();
  }

  // The kept slots' records: x, y, z, on; weighted r, g, b, 1.
  for (int s = threadIdx.x; s < n_kept; s += kThreads) {
    const int i = kept[s];
    const float* pos = in.position + (long long)i * p.pos_stride;
    const float* col = in.color + 4LL * i;
    const float cr = col[0] * p.tcolor[0];
    const float cg = col[1] * p.tcolor[1];
    const float cb = col[2] * p.tcolor[2];
    const float w = (col[3] * p.tcolor[3]) * p.weight;
    recs[2 * s] = make_float4(pos[0], pos[1], pos[2], 1.0f);
    recs[2 * s + 1] = make_float4(cr * w, cg * w, cb * w, 1.0f);
    if (in.dbg_idx) in.dbg_idx[(long long)t * p.capacity + s] = i;
  }
  if (in.dbg_count && threadIdx.x == 0) in.dbg_count[t] = n_kept;
  __syncthreads();

  // c, d. Each warp: a 32 x 2 sub-tile at a time.
  const float lo_raw = *in.light_occlusion;
  const bool occl_on = lo_raw > 0.0f;
  const float inv_lo = 1.0f / fmaxf(lo_raw, 1e-6f);
  const float inv_dot = (float)(1.0 / 0.15);
  const int subs_x = (p.tile + 31) / 32;
  const int subs = subs_x * ((p.tile + kRows - 1) / kRows);
  for (int sub = warp; sub < subs; sub += kWarps) {
    const int sy = sub / subs_x;
    const int col = (sub - sy * subs_x) * 32 + lane;
    const int gx = gx0 + col;
    const float wx = ((float)gx + 0.5f) / p.render_scale;
    float wy[kRows], wz[kRows], nx[kRows], ny[kRows], nz[kRows], f[kRows];
    bool no_normal[kRows];
    long long pix[kRows];
    Box box = {INFINITY, -INFINITY, INFINITY, -INFINITY, INFINITY,
               -INFINITY};
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int row = sy * kRows + k;
      const int gy = gy0 + row;
      const bool valid =
          col < p.tile && row < p.tile && gx < p.width && gy < p.height;
      pix[k] = valid ? (long long)gy * p.width + gx : -1;
      wy[k] = wz[k] = nx[k] = ny[k] = nz[k] = f[k] = 0.0f;
      no_normal[k] = true;
      if (valid) {
        const long long i = pix[k];
        wy[k] = ((float)gy + 0.5f) / p.render_scale + in.relative_y[i];
        wz[k] = in.z[i];
        nx[k] = in.normal[3 * i];
        ny[k] = in.normal[3 * i + 1];
        nz[k] = in.normal[3 * i + 2];
        no_normal[k] = nx[k] == 0.0f && ny[k] == 0.0f && nz[k] == 0.0f;
        f[k] = pixel_factor(p, in, i, wx, wy[k], wz[k], nz[k]);
        box.x0 = fminf(box.x0, wx);
        box.x1 = fmaxf(box.x1, wx);
        box.y0 = fminf(box.y0, wy[k]);
        box.y1 = fmaxf(box.y1, wy[k]);
        box.z0 = fminf(box.z0, wz[k]);
        box.z1 = fmaxf(box.z1, wz[k]);
      }
    }
    box.x0 = warp_min(box.x0);
    box.x1 = warp_max(box.x1);
    box.y0 = warp_min(box.y0);
    box.y1 = warp_max(box.y1);
    box.z0 = warp_min(box.z0);
    box.z1 = warp_max(box.z1);
    if (!(box.x0 <= box.x1)) continue;  // no pixel in the image (uniform)

    float acc[kRows][4];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
    for (int b0 = 0; b0 < n_kept; b0 += 32) {
      const int s = b0 + lane;
      const bool live = s < n_kept && reaches(recs[2 * s], box, p);
      unsigned m = __ballot_sync(kFull, live);
      while (m) {
        const int slot = b0 + __ffs(m) - 1;
        m &= m - 1u;
        const float4 a = recs[2 * slot];
        const float4 c = recs[2 * slot + 1];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float d3x = wx - a.x;
          const float d3y = (wy[k] - a.y) * p.y_factor;
          const float d3z = wz[k] - a.z;
          const float d2 = d3x * d3x + d3y * d3y + d3z * d3z + 1e-12f;
          const float inv = rsqrtf(d2);
          const float distance = d2 * inv;
          float df = 1.0f - saturate((distance - p.radius) * p.inv_ramp);
          if (occl_on) df = df * (1.0f - saturate(d3z * inv_lo));
          const float dot = -(d3x * nx[k] + d3y * ny[k] + d3z * nz[k]) * inv;
          const float x = saturate((dot + 0.15f) * inv_dot);
          float nf = fast_exp2(0.85f * fast_log2(x));
          if (no_normal[k]) nf = 1.0f;
          if (p.ramp_mode >= 2) {
            df = 1.0f - saturate(distance - p.radius);
            nf = 1.0f;
          } else if (p.ramp_mode >= 1) {
            df = df * df;
          }
          const float op =
              saturate(nf * df + saturate(p.radius - distance)) * a.w;
          acc[k][0] = acc[k][0] + op * c.x;
          acc[k][1] = acc[k][1] + op * c.y;
          acc[k][2] = acc[k][2] + op * c.z;
          acc[k][3] = acc[k][3] + op * c.w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long i = pix[k];
      if (i < 0) continue;
      if (p.with_alpha) {
        reinterpret_cast<float4*>(in.out)[i] =
            make_float4(acc[k][0] * f[k], acc[k][1] * f[k],
                        acc[k][2] * f[k], acc[k][3] * f[k]);
      } else {
        in.out[3 * i] = acc[k][0] * f[k];
        in.out[3 * i + 1] = acc[k][1] * f[k];
        in.out[3 * i + 2] = acc[k][2] * f[k];
      }
    }
  }
}

size_t smem_bytes(int capacity, int offsets) {
  return (size_t)capacity * (8 * sizeof(float) + sizeof(int)) +
         (size_t)offsets * 3 * sizeof(int) + 2 * kThreads * sizeof(int);
}

cudaError_t opt_in(size_t smem) {
  if (smem <= (size_t)kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(tiled_lights_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// ints: height, width, tile, n_lights, pos_stride, capacity, reps_x,
//   reps_y, ramp_mode, with_alpha, factor_mode, hc, wc (13);
// floats: render_scale, inf_x, inf_y, extra_y, radius, inv_ramp, y_factor,
//   cutoff, tcolor[4], weight, ao_radius, ao_opacity, ao_keep (16);
// geometry: the ColumnField's 12 floats (kColumnAo) or null.
extern "C" int tiled_lights(const float* z, const float* relative_y,
                            const float* normal, const float* factor,
                            const float* position, const float* color,
                            const uint8_t* active,
                            const float* light_occlusion, const float* pack,
                            float* out, int* diag, int* dbg_idx,
                            int* dbg_count, const int* ints,
                            const float* floats, const float* geometry,
                            cudaStream_t stream) {
  Params p;
  p.height = ints[0];
  p.width = ints[1];
  p.tile = ints[2];
  p.n_lights = ints[3];
  p.pos_stride = ints[4];
  p.capacity = ints[5];
  p.reps_x = ints[6];
  p.reps_y = ints[7];
  p.ramp_mode = ints[8];
  p.with_alpha = ints[9];
  p.factor_mode = ints[10];
  p.hc = ints[11];
  p.wc = ints[12];
  p.tiles_x = (p.width + p.tile - 1) / p.tile;
  p.offsets = (2 * p.reps_x + 1) * (2 * p.reps_y + 1);
  p.render_scale = floats[0];
  p.inf_x = floats[1];
  p.inf_y = floats[2];
  p.extra_y = floats[3];
  p.radius = floats[4];
  p.inv_ramp = floats[5];
  p.y_factor = floats[6];
  p.cutoff = floats[7];
  for (int c = 0; c < 4; ++c) p.tcolor[c] = floats[8 + c];
  p.weight = floats[12];
  p.ao_radius = floats[13];
  p.ao_opacity = floats[14];
  p.ao_keep = floats[15];
  p.geo = geometry ? illum_columns::geometry_from(geometry)
                   : illum_columns::Geometry{};
  Inputs in = {z, relative_y, normal, factor, position, color, active,
               light_occlusion, pack, out, diag, dbg_idx, dbg_count};
  const int tiles = ((p.height + p.tile - 1) / p.tile) * p.tiles_x;
  if (tiles <= 0) return 0;
  const size_t smem = smem_bytes(p.capacity, p.offsets);
  cudaError_t err = opt_in(smem);
  if (err != cudaSuccess) return (int)err;
  tiled_lights_kernel<<<tiles, kThreads, smem, stream>>>(in, p);
  return (int)cudaGetLastError();
}

// The launch at these sizes: threads, dynamic shared memory bytes, blocks
// an SM holds, registers and spilled (local) bytes a thread.
extern "C" int tiled_lights_plan(int capacity, int offsets, int* out) {
  const size_t smem = smem_bytes(capacity, offsets);
  cudaError_t err = opt_in(smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tiled_lights_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, tiled_lights_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}
