// The ColumnField query as device functions, shared by the column kernels
// (column_maps.cu: the sampler and the fused query) and the fused tiled
// particle lights (tiled_lights.cu: the AO sample, K10).
//
// `sample` is the bilinear sample of the quad-packed column maps
// (columns_kernel.pack_maps); `column_point` runs the whole query from a
// world position up to the reconstructed distance, keeping the terms the
// gradient needs; `column_distance` is the distance-only query. Edge rules
// are columns_pallas._rows exactly (i0 = clip(floor(t), 0, n - 1),
// i1 = min(i0 + 1, n - 1) baked into the pack, w = t - floor(t) from the
// unclipped floor). Every file that includes this header is compiled with
// -fmad=false, so the products and sums round one by one in the order of
// the plain PyTorch version (columns.query_reference).

#pragma once

#include <cuda_runtime.h>

namespace illum_columns {

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// The low tap i0 and the weight w of coordinate t on an axis of n texels
// (the high tap, min(i0 + 1, n - 1), is baked into the pack).
__device__ __forceinline__ void taps(float t, int n, int* i0, float* w) {
  float fl = floorf(t);
  *w = t - fl;
  // __float2int_rd saturates out-of-range values; the clip follows.
  int i = __float2int_rd(t);
  *i0 = min(max(i, 0), n - 1);
}

// N floats from a 16-byte aligned record, as ceil(N / 4) vector loads
// through the read-only path.
template <int N>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&v)[N]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < (N + 3) / 4; ++k) {
    const float4 a = __ldg(q + k);
    const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * k + j < N) v[4 * k + j] = e[j];
    }
  }
}

template <int NC>
struct Sample {
  float val[NC];  // bilinear value of each map
  float dtx;      // d(map 0)/dtx
  float dty;      // d(map 0)/dty
};

// The bilinear sample of the NC packed maps at texel coords (ty, tx): the
// one device function behind sample_maps, column_query and K10's AO.
template <int NC>
__device__ __forceinline__ void sample(const float* __restrict__ pack,
                                       int hc, int wc, float ty, float tx,
                                       bool grad, Sample<NC>* s) {
  int y0, x0;
  float wy, wx;
  taps(ty, hc, &y0, &wy);
  taps(tx, wc, &x0, &wx);
  // The record of (y0, x0) holds the taps at (y0, x0), (y0, x1),
  // (y1, x0), (y1, x1).
  float q[4 * NC];
  load<4 * NC>(pack + (long long)(y0 * wc + x0) * round4(4 * NC), q);
  float v00[NC], v01[NC], v10[NC], v11[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    v00[c] = q[c];
    v01[c] = q[NC + c];
    v10[c] = q[2 * NC + c];
    v11[c] = q[3 * NC + c];
  }
  const float ay = 1.0f - wy;
  const float ax = 1.0f - wx;
  float col0_0 = 0.0f, col1_0 = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    // y-lerp each of the two columns, then x-lerp: the order of the
    // Pallas kernel's (by @ map) then (. * bx) contraction.
    const float col0 = ay * v00[c] + wy * v10[c];
    const float col1 = ay * v01[c] + wy * v11[c];
    s->val[c] = ax * col0 + wx * col1;
    if (c == 0) {
      col0_0 = col0;
      col1_0 = col1;
    }
  }
  if (grad) {
    s->dtx = col1_0 - col0_0;
    const float row0 = ax * v00[0] + wx * v01[0];
    const float row1 = ax * v10[0] + wx * v11[0];
    s->dty = row1 - row0;
  }
}

// The ColumnField's constants, float32 as the plain version rounds its
// Python scalars (columns_kernel.QUERY_GEOMETRY names them in order).
struct Geometry {
  float ex, ey, ez, z_offset;  // virtual box and its z offset
  float scale_x, scale_y;      // world -> fine texel
  float rx, ry;                // fine texel -> coarse texel
  float sx_c, sy_c;            // coarse texel derivative -> world
  float z_lo, z_hi;            // the end slices' world z
};

constexpr int kColumnMaps = 5;  // f, t, b, d_top, d_bot

// One query point up to the reconstructed distance `d` (before the end
// clamp `lip` and the out-of-volume `dist` are applied), with the terms
// the gradient reads.
struct ColumnPoint {
  float ux, uy, uz;  // signed out-of-box offsets
  bool in_x, in_y;   // strictly inside the box on x, y
  float dist;        // out-of-volume distance
  float lip_top, lip_bot, lip;
  float below, above, dz, f, f_pos, dz_pos, outside, d;
  Sample<kColumnMaps> s;
};

__device__ __forceinline__ void column_point(const float* __restrict__ pack,
                                             int hc, int wc,
                                             const Geometry& g, float px,
                                             float py, float pz, bool grad,
                                             ColumnPoint* c) {
  // sampling._clamped_axes: the clamp into the box and the signed
  // out-of-box offsets. (Its slice coordinate and z mask, the only terms
  // that read max_valid_z, do not enter the column query.)
  const float pzr = pz - g.z_offset;
  const float cx = fminf(fmaxf(px, 0.0f), g.ex);
  const float cy = fminf(fmaxf(py, 0.0f), g.ey);
  c->ux = fminf(px, 0.0f) + fmaxf(px - g.ex, 0.0f);
  c->uy = fminf(py, 0.0f) + fmaxf(py - g.ey, 0.0f);
  c->uz = fminf(pzr, 0.0f) + fmaxf(pzr - g.ez, 0.0f);
  c->in_x = (px > 0.0f) && (px < g.ex);
  c->in_y = (py > 0.0f) && (py < g.ey);

  // columns._map_coords: fine texel coords, then the coarse map's.
  float tx = cx * g.scale_x - 0.5f;
  float ty = cy * g.scale_y - 0.5f;
  tx = (tx + 0.5f) * g.rx - 0.5f;
  ty = (ty + 0.5f) * g.ry - 0.5f;

  sample<kColumnMaps>(pack, hc, wc, ty, tx, grad, &c->s);
  const float f = c->s.val[0], t = c->s.val[1], b = c->s.val[2];
  const float d_top = c->s.val[3], d_bot = c->s.val[4];

  // columns._finish: reconstruct at the z clamped to the end slices, the
  // 1-Lipschitz end-slice clamps, then the out-of-volume distance.
  const float pzc = fminf(fmaxf(pz - c->uz, g.z_lo), g.z_hi);
  c->dist = sqrtf(c->ux * c->ux + c->uy * c->uy + c->uz * c->uz);
  c->lip_top = d_top + (g.z_hi - pzc);
  c->lip_bot = d_bot + (pzc - g.z_lo);
  c->lip = fminf(c->lip_top, c->lip_bot);

  // columns._reconstruct.
  c->below = b - pzc;
  c->above = pzc - t;
  c->dz = fmaxf(c->below, c->above);
  c->f = f;
  c->f_pos = fmaxf(f, 0.0f);
  c->dz_pos = fmaxf(c->dz, 0.0f);
  c->outside = sqrtf(c->f_pos * c->f_pos + c->dz_pos * c->dz_pos);
  c->d = fminf(fmaxf(f, c->dz), 0.0f) + c->outside;
}

// The distance-only ColumnField query at a world position.
__device__ __forceinline__ float column_distance(
    const float* __restrict__ pack, int hc, int wc, const Geometry& g,
    float px, float py, float pz) {
  ColumnPoint c;
  column_point(pack, hc, wc, g, px, py, pz, false, &c);
  return fminf(c.d, c.lip) + c.dist;
}

// The 12 floats of Geometry, in its order, from host memory.
inline Geometry geometry_from(const float* v) {
  Geometry g;
  g.ex = v[0];
  g.ey = v[1];
  g.ez = v[2];
  g.z_offset = v[3];
  g.scale_x = v[4];
  g.scale_y = v[5];
  g.rx = v[6];
  g.ry = v[7];
  g.sx_c = v[8];
  g.sy_c = v[9];
  g.z_lo = v[10];
  g.z_hi = v[11];
  return g;
}

}  // namespace illum_columns
