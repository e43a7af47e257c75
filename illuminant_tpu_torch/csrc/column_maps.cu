// Column-map sampler and the fused ColumnField query for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel illuminant_tpu/sdf/columns_pallas.py:
// sample_maps (one-hot interpolation rows contracted with the maps on the
// MXU) and, in column_query, the XLA elementwise head and tail that wrap
// it in illuminant_tpu/sdf/columns.py (_map_coords before the sample,
// _finish / _reconstruct after it) plus the unit normalisation of
// illuminant_tpu/sdf/analytic.py (_normalized).
//
// What bounds it on an H100: bytes. A gradient query at 1M points moves
// x, y, z in and d, gx, gy, gz out (28 B a point) around a few hundred
// float operations, far below the card's operation rate. Two things stood
// between the first port and that bound:
//   * the maps were planar, so a point's 5 maps x 4 taps were 20
//     scattered 4-byte L2 requests. Here the wrapper first packs the maps
//     into one "quad" record per texel: the four taps of the cell whose
//     low corner is the texel, with the i1 = min(i0 + 1, n - 1) edge
//     clamp baked in, 4 * C floats read as 5 16-byte vector loads at
//     C = 5 (3 sectors a point; 2.6 MB at the flagship's maps, held in
//     L2). It beat a texel-interleaved pack (the C maps of a texel in one
//     32-byte sector, 8 vector loads a point) on uniform points and on
//     the frame's own (PERF.md);
//   * the query ran as ~80 elementwise PyTorch passes over the points
//     around the sample. column_query_kernel runs the whole query in
//     registers: one launch, the points read once, the results written
//     once. The sample and the query are device functions of
//     column_query.cuh, which K10 (tiled_lights.cu) shares for its AO.
//
// Edge rules are columns_pallas._rows exactly (not the texture unit's
// clamp or its 8-bit weights): i0 = clip(floor(t), 0, n - 1),
// i1 = min(i0 + 1, n - 1), w = t - floor(t) from the unclipped floor.
// The maps stay float32 (the TPU kernel cast them to bf16 for the MXU).
//
// The file is compiled with -fmad=false: every product and sum rounds on
// its own, in the order of the plain PyTorch version (columns_kernel.
// sample_maps_reference, columns.query_reference), so the kernel matches
// it to the rounding of sqrt and division, which are IEEE on both sides.

#include <cuda_runtime.h>
#include <stdint.h>

#include "column_query.cuh"

namespace {

using namespace illum_columns;

constexpr int kThreads = 256;

// One thread per texel: the quad record of texel (y, x), the NC maps at
// (y, x), (y, x1), (y1, x), (y1, x1) with the edge clamp baked in, zero
// padded to round4(4 * NC) floats, built in registers and stored as
// 16-byte vectors.
template <int NC>
__global__ void pack_quad_kernel(const float* __restrict__ maps,
                                 float* __restrict__ pack, int hc, int wc) {
  constexpr int kRec = round4(4 * NC);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = hc * wc;
  if (t >= plane) return;
  const int y = t / wc;
  const int x = t - y * wc;
  const int y1 = min(y + 1, hc - 1);
  const int x1 = min(x + 1, wc - 1);
  const int src[4] = {t, y * wc + x1, y1 * wc + x, y1 * wc + x1};
  float r[kRec];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      r[k * NC + c] = __ldg(maps + (long long)c * plane + src[k]);
  }
#pragma unroll
  for (int s = 4 * NC; s < kRec; ++s) r[s] = 0.0f;
  float4* dst = reinterpret_cast<float4*>(pack + (long long)t * kRec);
#pragma unroll
  for (int j = 0; j < kRec / 4; ++j)
    dst[j] = make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
}

// Output rows out[c * n + i]: the bilinear value of map c at point i; with
// want_grad, rows C and C + 1 hold d(map 0)/dtx and d(map 0)/dty.
template <int NC>
__global__ void sample_maps_kernel(const float* __restrict__ pack,
                                   const float* __restrict__ ty,
                                   const float* __restrict__ tx,
                                   float* __restrict__ out, int hc, int wc,
                                   long long n, int want_grad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Sample<NC> s;
  sample<NC>(pack, hc, wc, __ldg(ty + i), __ldg(tx + i), want_grad != 0,
             &s);
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c * n + i] = s.val[c];
  if (want_grad) {
    out[NC * n + i] = s.dtx;
    out[(NC + 1) * n + i] = s.dty;
  }
}

__global__ void column_query_kernel(
    const float* __restrict__ pack, int hc, int wc, Geometry g,
    const float* __restrict__ xs, long long sx,
    const float* __restrict__ ys, long long sy,
    const float* __restrict__ zs, long long sz, long long n, int want_grad,
    int normalize, float* __restrict__ d_out, float* __restrict__ gx_out,
    float* __restrict__ gy_out, float* __restrict__ gz_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = __ldg(xs + i * sx);
  const float py = __ldg(ys + i * sy);
  const float pz = __ldg(zs + i * sz);
  if (!want_grad) {
    d_out[i] = column_distance(pack, hc, wc, g, px, py, pz);
    return;
  }
  float gx, gy, gz;
  d_out[i] = column_distance_grad(pack, hc, wc, g, px, py, pz,
                                  normalize != 0, &gx, &gy, &gz);
  gx_out[i] = gx;
  gy_out[i] = gy;
  gz_out[i] = gz;
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int column_maps_pack(const void* maps, void* pack, int n_maps,
                                int hc, int wc, void* stream) {
  const long long plane = (long long)hc * wc;
  if (plane <= 0) return 0;
  const unsigned int blocks = blocks_for(plane);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* src = (const float*)maps;
  float* dst = (float*)pack;
#define ILLUM_PACK_CASE(NC)                                                 \
  case NC:                                                                  \
    pack_quad_kernel<NC><<<blocks, kThreads, 0, st>>>(src, dst, hc, wc);    \
    break;
  switch (n_maps) {
    ILLUM_PACK_CASE(1)
    ILLUM_PACK_CASE(2)
    ILLUM_PACK_CASE(3)
    ILLUM_PACK_CASE(4)
    ILLUM_PACK_CASE(5)
    ILLUM_PACK_CASE(6)
    ILLUM_PACK_CASE(7)
    ILLUM_PACK_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ILLUM_PACK_CASE
  return (int)cudaGetLastError();
}

extern "C" int column_maps_sample(const void* pack_, const void* ty_,
                                  const void* tx_, void* out_, int n_maps,
                                  int hc, int wc, long long n, int want_grad,
                                  void* stream_) {
  if (n <= 0) return 0;
  const float* pack = (const float*)pack_;
  const float* ty = (const float*)ty_;
  const float* tx = (const float*)tx_;
  float* out = (float*)out_;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const unsigned int blocks = blocks_for(n);
#define ILLUM_SAMPLE_CASE(NC)                                            \
  case NC:                                                               \
    sample_maps_kernel<NC><<<blocks, kThreads, 0, stream>>>(             \
        pack, ty, tx, out, hc, wc, n, want_grad);                        \
    break;
  switch (n_maps) {
    ILLUM_SAMPLE_CASE(1)
    ILLUM_SAMPLE_CASE(2)
    ILLUM_SAMPLE_CASE(3)
    ILLUM_SAMPLE_CASE(4)
    ILLUM_SAMPLE_CASE(5)
    ILLUM_SAMPLE_CASE(6)
    ILLUM_SAMPLE_CASE(7)
    ILLUM_SAMPLE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ILLUM_SAMPLE_CASE
  return (int)cudaGetLastError();
}

// geometry: the 12 floats of Geometry, in its order, in host memory.
extern "C" int column_query(const void* pack, int hc, int wc,
                            const float* geometry, const void* x,
                            long long sx, const void* y, long long sy,
                            const void* z, long long sz, long long n,
                            int want_grad, int normalize, void* d, void* gx,
                            void* gy, void* gz, void* stream) {
  if (n <= 0) return 0;
  const illum_columns::Geometry g = illum_columns::geometry_from(geometry);
  const unsigned int blocks = blocks_for(n);
  const cudaStream_t st = (cudaStream_t)stream;
  column_query_kernel<<<blocks, kThreads, 0, st>>>(
      (const float*)pack, hc, wc, g, (const float*)x, sx, (const float*)y, sy,
      (const float*)z, sz, n, want_grad, normalize, (float*)d, (float*)gx,
      (float*)gy, (float*)gz);
  return (int)cudaGetLastError();
}
