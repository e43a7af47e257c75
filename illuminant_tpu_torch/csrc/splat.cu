// K5: the additive particle splat for Hopper (sm_90a).
//
// Replaces the XLA device work of illuminant_tpu/raster/tiled.py:
// rasterize_tiled (:589; its sort into fixed-capacity 32-px tile bins and
// the separable one-hot matmul splat on the MXU; the JAX package has no
// Pallas kernel for it) and, in the port, the plain direct splat of
// raster/tiled.py:rasterize_tiled_reference, which gathers the live
// on-screen particles with `nonzero` and sizes its 2k + 1 `index_add_`
// passes by the largest radius, two device-to-host reads a call.
//
// One thread a particle. It tests the particle on screen, clamps its
// radius to [0.5, apron + 0.5], finds its tile by truncation and that
// tile's window [t T - A, t T + T + A) clipped to the image, and walks its
// own support: the taps within ceil(support(radius)) + 1 of its floor,
// beyond which every profile is exactly 0 (tiled._support), not the
// call's largest. Each tap inside the window adds color x wy x wx to its
// pixel with float atomics. Nothing is gathered, nothing read back, and
// no bin has a capacity: no particle is ever dropped.
//
// What bounds it on an H100: the atomics into the image. The particle
// records (x, y, size, live, colour) are read once and the image written
// once; the flagship frame's 1M particles add a few tens of taps each.
// Float atomics reorder each pixel's sum (index_add_ on the card is
// atomic too, so the plain version is not bitwise stable either); the
// weights themselves are the plain version's bit for bit: the file is
// compiled with -fmad=false and each profile keeps tiled._profile's
// operation order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// tiled.py's kernel names, in the wrapper's KERNELS order.
enum Kind { kPoint = 0, kQuad = 1, kGauss = 2, kRound = 3 };

struct Splat {
  const float* x;
  const float* y;
  const float* size;
  const unsigned char* live;
  const float* color;
  long long sx, sy, ssize, slive, scolor_row, scolor_col;
  long long n;
  float* image;  // (H * W, C)
  int height, width, tile, apron, grid_y, grid_x, channels, kind;
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// tiled._profile: the 1-D coverage at signed distance d.
__device__ __forceinline__ float profile(int kind, float d, float r) {
  if (kind == kPoint) return clamp01(1.0f - fabsf(d));
  if (kind == kQuad) return clamp01(r - fabsf(d) + 0.5f);
  if (kind == kGauss) {
    const float sigma = fmaxf(r * 0.5f, 0.3f);
    const float e = d / sigma;
    const float q = 0.5f * (e * e);
    const float base = fmaxf(1.0f - q * 0.125f, 0.0f);
    const float b2 = base * base;
    const float b4 = b2 * b2;
    return b4 * b4;
  }
  const float t = clamp01(r - fabsf(d) + 0.5f);
  const float edge = clamp01(fabsf(d) / fmaxf(r, 0.5f));
  const float u = edge * edge;
  return t * (0.99924356f - (0.24155038f + 0.04961871f * u) * u);
}

// tiled._support: the half-width beyond which the profile is 0.
__device__ __forceinline__ float support(int kind, float r) {
  if (kind == kPoint) return 1.0f;
  if (kind == kGauss) return 4.0f * fmaxf(r * 0.5f, 0.3f);
  return r + 0.5f;
}

// The particle's tile on one axis by truncation (the JAX int cast),
// clipped to the grid, and its window [lo, hi) clipped to the image.
__device__ __forceinline__ void window(float p, int tile, int apron, int g,
                                       int extent, int* lo, int* hi) {
  const float q = p / (float)tile;
  const int t = min(max(__float2int_rz(q), 0), g - 1);
  *lo = max(t * tile - apron, 0);
  *hi = min(t * tile + tile + apron, extent);
}

__global__ void __launch_bounds__(kThreads) splat_kernel(Splat s) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s.n) return;
  if (!__ldg(s.live + i * s.slive)) return;
  const float x = __ldg(s.x + i * s.sx);
  const float y = __ldg(s.y + i * s.sy);
  const float a1 = (float)s.apron + 1.0f;
  if (!((x > -a1) && (x < (float)s.width + a1) && (y > -a1) &&
        (y < (float)s.height + a1)))
    return;
  const float r = fminf(fmaxf(__ldg(s.size + i * s.ssize) * 0.5f, 0.5f),
                        (float)s.apron + 0.5f);
  const int k = (int)ceilf(support(s.kind, r)) + 1;
  int xlo, xhi, ylo, yhi;
  window(x, s.tile, s.apron, s.grid_x, s.width, &xlo, &xhi);
  window(y, s.tile, s.apron, s.grid_y, s.height, &ylo, &yhi);
  const int fx = (int)floorf(x);
  const int fy = (int)floorf(y);
  float c[4];
  for (int ch = 0; ch < s.channels; ++ch) {
    c[ch] = __ldg(s.color + i * s.scolor_row + ch * s.scolor_col);
  }
  const int py0 = max(fy - k, ylo), py1 = min(fy + k, yhi - 1);
  const int px0 = max(fx - k, xlo), px1 = min(fx + k, xhi - 1);
  for (int py = py0; py <= py1; ++py) {
    const float wy = profile(s.kind, (float)py + 0.5f - y, r);
    if (wy == 0.0f) continue;
    float* row = s.image + (long long)py * s.width * s.channels;
    for (int px = px0; px <= px1; ++px) {
      const float wx = profile(s.kind, (float)px + 0.5f - x, r);
      const float w = wy * wx;
      if (w == 0.0f) continue;
      float* dst = row + (long long)px * s.channels;
      for (int ch = 0; ch < s.channels; ++ch) atomicAdd(dst + ch, w * c[ch]);
    }
  }
}

}  // namespace

// ptrs: x, y, size, live (1 byte a particle), color, image.
// strides: x, y, size, live, color row, color column (elements).
// ints: n, height, width, tile, apron, grid_y, grid_x, channels, kind.
extern "C" int splat(const void* const* ptrs, const long long* strides,
                     const long long* ints, void* stream) {
  Splat s;
  s.x = (const float*)ptrs[0];
  s.y = (const float*)ptrs[1];
  s.size = (const float*)ptrs[2];
  s.live = (const unsigned char*)ptrs[3];
  s.color = (const float*)ptrs[4];
  s.image = (float*)ptrs[5];
  s.sx = strides[0];
  s.sy = strides[1];
  s.ssize = strides[2];
  s.slive = strides[3];
  s.scolor_row = strides[4];
  s.scolor_col = strides[5];
  s.n = ints[0];
  s.height = (int)ints[1];
  s.width = (int)ints[2];
  s.tile = (int)ints[3];
  s.apron = (int)ints[4];
  s.grid_y = (int)ints[5];
  s.grid_x = (int)ints[6];
  s.channels = (int)ints[7];
  s.kind = (int)ints[8];
  if (s.channels < 1 || s.channels > 4 || s.kind < 0 || s.kind > 3)
    return (int)cudaErrorInvalidValue;
  if (s.n <= 0) return 0;
  const unsigned int blocks =
      (unsigned int)((s.n + kThreads - 1) / kThreads);
  splat_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}
