// Tiled particle-light shading for Hopper (sm_90a): K10.
//
// Replaces the XLA shading of illuminant_tpu/lighting/tiled_lights.py:
// accumulate_sphere_lights_tiled (:229-291). There each K-chunk of 8
// binned lights becomes (T, 8, tile, tile) opacity planes that an einsum
// contracts in bfloat16 with the lights' colours on the TPU's matrix unit,
// over a frame padded to whole tiles and un-tiled again. Here the sum runs
// the way a rasteriser's per-light quads would: one block per screen tile
// stages the tile's binned light records in shared memory, each thread
// shades pixels of the tile against them in slot order, accumulating in
// registers, and writes its pixels straight into the (H, W, 4) (or 3)
// image. Edge tiles are guarded; there is no pad and no un-tile pass.
//
// Inputs: the G-buffer planes z, relative_y (H, W) and normal (H, W, 3);
// pix_f (H, W), the per-pixel factor (fullbright discard x AO) the plain
// epilogue computes; the (T, K) binned light indices and their mask; the
// (N, 8) light records x, y, z, on, r, g, b, 1 (on = live, rgb weighted
// by alpha x opacity x brightness); and the environment's light_occlusion
// as a device scalar, so that nothing is read back to the host.
//
// What bounds it on an H100: operations and bytes about equally. A 1080p
// frame with 2048 lights of the particle-lights cell bins ~20 lights a
// tile, ~40M (light, pixel) pairs of some 41 float operations each with
// the light occlusion off (about 1.7 GFLOP, 0.025 ms at the 67 TFLOP/s
// float32 peak), against ~83 MB of planes, lists and image (0.025 ms at
// 3.35 TB/s). This first version is simple: 256 threads a
// block, a thread one pixel at a time with the slot loop innermost (the
// records are broadcast reads from shared memory), slots with no live
// light skipped (warp-uniform: every thread of a block reads the same
// slot). Levers for a later redesign are in ROADMAP (K10).
//
// Rounding: the file is compiled with -fmad=false and follows the plain
// version's operation order (lighting/tiled_lights_kernel.py:
// tiled_light_accumulate_reference): products and sums round one by one,
// a skipped slot adds exactly +0 in the plain version. K10 is still held
// to a bound, 1e-5 x (1 + the image's largest value), not to bit equality:
// sqrtf, powf (the normal ramp's ** 0.85) and the divisions here need not
// round as torch's CUDA operations do. Which of them makes the difference
// measured on the cell's frame (9.5e-7 at a largest value of ~5.4) has not
// been checked; that torch's float32 sqrt differs from sqrtf is a
// hypothesis, from the jump flood's roots (utils/jumpflood.py).
//
// The wrapper checks the tile and slot limits before it calls in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRecord = 8;
constexpr int kStaticSmem = 48 * 1024;

struct Params {
  int height, width, tile, tiles_x, capacity;
  float radius, ramp_length, y_factor, render_scale;
  int ramp_mode, with_alpha;
};

__device__ __forceinline__ float saturate(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
tiled_lights_kernel(const float* __restrict__ z,
                    const float* __restrict__ relative_y,
                    const float* __restrict__ normal,
                    const float* __restrict__ pix_f,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ records,
                    const float* __restrict__ light_occlusion,
                    float* __restrict__ out, Params p) {
  extern __shared__ float4 recs[];  // 2 float4 a slot
  const int t = blockIdx.x;
  const int ty = t / p.tiles_x;
  const int tx = t - ty * p.tiles_x;

  // Stage the tile's slots: position and on, then weighted colour.
  for (int s = threadIdx.x; s < p.capacity; s += blockDim.x) {
    const long long k = (long long)t * p.capacity + s;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 b = a;
    if (mask[k]) {
      const float4* r =
          reinterpret_cast<const float4*>(records + (long long)idx[k] * kRecord);
      a = r[0];
      b = r[1];
    }
    recs[2 * s] = a;
    recs[2 * s + 1] = b;
  }
  __syncthreads();

  const float lo_raw = *light_occlusion;
  const bool occl_on = lo_raw > 0.0f;
  const float lo = fmaxf(lo_raw, 1e-6f);
  const int pixels = p.tile * p.tile;
  for (int q = threadIdx.x; q < pixels; q += blockDim.x) {
    const int py = q / p.tile;
    const int gy = ty * p.tile + py;
    const int gx = tx * p.tile + (q - py * p.tile);
    if (gy >= p.height || gx >= p.width) continue;
    const long long i = (long long)gy * p.width + gx;
    const float wx = ((float)gx + 0.5f) / p.render_scale;
    const float wy = ((float)gy + 0.5f) / p.render_scale + relative_y[i];
    const float wz = z[i];
    const float nx = normal[3 * i];
    const float ny = normal[3 * i + 1];
    const float nz = normal[3 * i + 2];
    const bool no_normal = nx == 0.0f && ny == 0.0f && nz == 0.0f;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
    for (int s = 0; s < p.capacity; ++s) {
      const float4 a = recs[2 * s];
      if (a.w == 0.0f) continue;
      const float4 c = recs[2 * s + 1];
      const float d3x = wx - a.x;
      const float d3y = (wy - a.y) * p.y_factor;
      const float d3z = wz - a.z;
      const float distance =
          sqrtf(d3x * d3x + d3y * d3y + d3z * d3z + 1e-12f);
      float df = 1.0f - saturate((distance - p.radius) / p.ramp_length);
      if (occl_on) df = df * (1.0f - saturate(d3z / lo));
      const float dot = -(d3x * nx + d3y * ny + d3z * nz) / distance;
      float nf = powf(saturate((dot + 0.15f) / 0.15f), 0.85f);
      if (no_normal) nf = 1.0f;
      if (p.ramp_mode >= 2) {
        df = 1.0f - saturate(distance - p.radius);
        nf = 1.0f;
      } else if (p.ramp_mode >= 1) {
        df = df * df;
      }
      const float op = saturate(nf * df + saturate(p.radius - distance)) * a.w;
      acc0 = acc0 + op * c.x;
      acc1 = acc1 + op * c.y;
      acc2 = acc2 + op * c.z;
      acc3 = acc3 + op * c.w;
    }
    const float f = pix_f[i];
    if (p.with_alpha) {
      reinterpret_cast<float4*>(out)[i] =
          make_float4(acc0 * f, acc1 * f, acc2 * f, acc3 * f);
    } else {
      out[3 * i] = acc0 * f;
      out[3 * i + 1] = acc1 * f;
      out[3 * i + 2] = acc2 * f;
    }
  }
}

size_t smem_bytes(int capacity) {
  return (size_t)capacity * kRecord * sizeof(float);
}

cudaError_t opt_in(size_t smem) {
  if (smem <= (size_t)kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(tiled_lights_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int tiled_lights(const float* z, const float* relative_y,
                            const float* normal, const float* pix_f,
                            const int32_t* idx, const uint8_t* mask,
                            const float* records,
                            const float* light_occlusion, float* out,
                            int height, int width, int tile, int capacity,
                            float radius, float ramp_length, float y_factor,
                            int ramp_mode, float render_scale,
                            int with_alpha, cudaStream_t stream) {
  Params p;
  p.height = height;
  p.width = width;
  p.tile = tile;
  p.tiles_x = (width + tile - 1) / tile;
  p.capacity = capacity;
  p.radius = radius;
  p.ramp_length = ramp_length;
  p.y_factor = y_factor;
  p.render_scale = render_scale;
  p.ramp_mode = ramp_mode;
  p.with_alpha = with_alpha;
  const int tiles = ((height + tile - 1) / tile) * p.tiles_x;
  const size_t smem = smem_bytes(capacity);
  cudaError_t err = opt_in(smem);
  if (err != cudaSuccess) return (int)err;
  tiled_lights_kernel<<<tiles, kThreads, smem, stream>>>(
      z, relative_y, normal, pix_f, idx, mask, records, light_occlusion, out,
      p);
  return (int)cudaGetLastError();
}

// The launch at these sizes: threads, dynamic shared memory bytes, blocks
// an SM holds, registers and spilled (local) bytes a thread.
extern "C" int tiled_lights_plan(int tile, int capacity, int* out) {
  const size_t smem = smem_bytes(capacity);
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
