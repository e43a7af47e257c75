// Column-map sampler for Hopper (sm_90a): the bilinear sample of a
// (C, Hc, Wc) float32 map pack at N texel coordinates (ty, tx), with the
// two texel-space derivatives of map 0 when want_grad is set.
//
// Replaces the Pallas TPU kernel illuminant_tpu/sdf/columns_pallas.py:
// sample_maps, which built one-hot interpolation rows and contracted them
// with the maps on the MXU. On the card the same function is a 4-tap
// gather per point: one thread per point, the maps (648 KB at the 1080p
// flagship's 5 x 135 x 240) read through the read-only path and resident
// in L2, outputs written point-major so that a warp's stores coalesce.
//
// Edge rules follow columns_pallas._rows exactly (not the texture unit's
// clamp): i0 = clip(floor(t), 0, n - 1), i1 = min(i0 + 1, n - 1),
// w = t - floor(t) taken from the unclipped floor.
//
// Output rows: out[c * n + i] for c < C the bilinear value of map c;
// with want_grad, out[C * n + i] = d(map 0)/dtx and
// out[(C + 1) * n + i] = d(map 0)/dty at point i.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void taps(float t, int n, int* i0, int* i1,
                                     float* w) {
  float fl = floorf(t);
  *w = t - fl;
  // __float2int_rd saturates out-of-range values; the clip follows.
  int i = __float2int_rd(t);
  i = min(max(i, 0), n - 1);
  *i0 = i;
  *i1 = min(i + 1, n - 1);
}

__global__ void sample_maps_kernel(const float* __restrict__ maps,
                                   const float* __restrict__ ty,
                                   const float* __restrict__ tx,
                                   float* __restrict__ out, int n_maps,
                                   int hc, int wc, long long n,
                                   int want_grad) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int y0, y1, x0, x1;
  float wy, wx;
  taps(__ldg(ty + i), hc, &y0, &y1, &wy);
  taps(__ldg(tx + i), wc, &x0, &x1, &wx);
  const long long plane = (long long)hc * wc;
  const int o00 = y0 * wc + x0;
  const int o01 = y0 * wc + x1;
  const int o10 = y1 * wc + x0;
  const int o11 = y1 * wc + x1;
  for (int c = 0; c < n_maps; ++c) {
    const float* m = maps + c * plane;
    // y-lerp each of the two columns, then x-lerp: the order of the
    // Pallas kernel's (by @ map) then (. * bx) contraction.
    float col0 = (1.0f - wy) * __ldg(m + o00) + wy * __ldg(m + o10);
    float col1 = (1.0f - wy) * __ldg(m + o01) + wy * __ldg(m + o11);
    out[c * n + i] = (1.0f - wx) * col0 + wx * col1;
    if (want_grad && c == 0) {
      out[(long long)n_maps * n + i] = col1 - col0;
      float row0 = (1.0f - wx) * __ldg(m + o00) + wx * __ldg(m + o01);
      float row1 = (1.0f - wx) * __ldg(m + o10) + wx * __ldg(m + o11);
      out[(long long)(n_maps + 1) * n + i] = row1 - row0;
    }
  }
}

}  // namespace

extern "C" int column_maps_sample(const void* maps, const void* ty,
                                  const void* tx, void* out, int n_maps,
                                  int hc, int wc, long long n,
                                  int want_grad, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sample_maps_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)maps, (const float*)ty, (const float*)tx, (float*)out,
      n_maps, hc, wc, n, want_grad);
  return (int)cudaGetLastError();
}
