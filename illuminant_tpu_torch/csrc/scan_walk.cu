// K1: the scan shadows' column walk (lighting/scan_shadows.py) for Hopper
// (sm_90a).
//
// Replaces the per-column Python loop of the port's
// lighting/scan_shadows.py:_bidirectional_scan, which stays as the plain
// version for CPU tensors, and through it the `lax.scan` of
// illuminant_tpu/lighting/scan_shadows.py:_bidirectional_scan (:150; the
// JAX package has no Pallas kernel for it). The eager loop walks the
// columns one at a time, ~16 small kernels a column: ~12,000 launches
// a 1080p flagship frame (270 x 480 nomination grid, both axes), whose
// host time was most of the frame. K1 is one launch a `scan_visibility`
// call: every axis, direction and light.
//
// One block a (sector, light): sectors east, west (the x-flipped walk),
// north, south (the walk on the transposed image, and its flip). A thread
// owns R consecutive rows of the walk (R = 1 up to 1,024 rows, 2 or 4
// beyond) and the block steps over the columns in order. A row's carries
// (d, k, neg_k[, f_min][, h_top, h_bot, row phase]) live in registers;
// the rows above and below come from the neighbouring lanes by warp
// shuffles and, at a warp's edge, from a double-buffered row of
// warp-edge values in shared memory: one barrier a column. The fan
// geometry (dx, f, |f|, 1 - |f|, f >= 0, in front, valid) is computed in
// registers from the light's (along, across, radius) and the row and
// column index; no (W, 2, L, H) tensor is made. The image columns
// (occlusion[, footprint][, h_top, h_bot]) are staged a tile of C
// columns at a time in shared memory by asynchronous copies issued one
// tile ahead, coalesced: along a row for east / west (C = 8: a 32-byte
// sector a row), along a column for north / south. The carries arriving
// at each column (before the column's own data merges) are written
// straight into their sector's readout layout, (4, KOUT, L, H, W):
// west's flip and north / south's transpose are undone by the store's
// index. North and south store a column per step, coalesced; east and
// west buffer a tile of columns in shared memory and write it out along
// the rows.
//
// What bounds it on an H100: latency. Each block is a chain of W (or H)
// dependent steps with a barrier each (480 at the flagship's grid), and
// the launch has only 4 L blocks (32 at the flagship), so the card is
// nearly empty. The bytes are small: the carries written once, 4 x KOUT
// x L x H x W x 4 B (50 MB at the flagship's 8 lights, 270 x 480, KOUT
// 3: 15 us at 3.35 TB/s), and the image read once. The design keeps
// each step short: no global load on the chain (the tiles arrive a tile
// ahead), no division but the one IEEE division a row the plain version
// does, shuffles in place of shared memory inside a warp. Two further
// cuts timed slower on the flagship's walk (0.41-0.43 against 0.32 ms on
// an H100): letting the warps that own no row (east / west blocks take
// the north / south walk's block size) skip all but the barriers, and
// moving the division ahead of the barrier.
//
// Rounding: the carries must equal the eager loop's on the card bit for
// bit, the arg-min k included. On a plateau of the occlusion image (the
// flat interior of a prism cut by the trace plane) the resample lands
// within an ulp of the plateau's value and the strict `<` of the arg-min
// update moves or stays by that ulp. The file is compiled with
// -fmad=false, every operation is the plain version's in its order, the
// division is IEEE (`__fdiv_rn`), and the resample rounds as
// `torch.addcmul(shifted * |f|, carry, 1 - |f|)` does on the card
// (`resample` below). min, max and clamp propagate NaN as torch's do;
// the phase's round is rintf, half to even, as torch.round.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const float* image[4];  // occlusion[, footprint][, h_top, h_bot]
  const float* lx;        // (L,) light x in grid pixels
  const float* ly;        // (L,) light y
  const float* lr;        // (L,) near-light skip radius
  float* out;             // (4, KOUT, L, height, width)
  int height, width, lights, tile_cols;
  float band, big, top_fill, bot_fill;
};

// torch.minimum, torch.clamp(min=), torch.clamp(min, max) on CUDA floats.
__device__ __forceinline__ float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// The plain version's `torch.addcmul(shifted * af, carry, near)` as
// PyTorch computes it on the card: the product shifted * af rounded, then
// carry * near added to it in one fused multiply-add (one rounding).
__device__ __forceinline__ float resample(float carry, float near,
                                          float shifted, float af) {
  return __fmaf_rn(carry, near, __fmul_rn(shifted, af));
}

// Shared memory of a block: the image tiles [2][NIN][C][P], for east /
// west the output tiles [2][KOUT][C][P], then the warp-edge rows
// [2][warps][2][NX]. P: the walk's rows padded to 32 plus 4, so the
// east / west tiles' row-major copies (8 columns by 4 rows a warp) fall
// on 32 banks.
__host__ __device__ __forceinline__ int padded_rows(int rows) {
  return ((rows + 31) / 32) * 32 + 4;
}

template <int R, bool kFoot, bool kExtra>
__global__ void __launch_bounds__(kMaxThreads)
    scan_walk_kernel(const Params p) {
  constexpr int K = kFoot ? 4 : 3;       // resampled carries
  constexpr int NX = K + (kExtra ? 3 : 0);  // a row's whole state
  constexpr int NIN = 1 + (kFoot ? 1 : 0) + (kExtra ? 2 : 0);
  constexpr int KOUT = K + (kExtra ? 2 : 0);
  constexpr int kTop_in = kFoot ? 2 : 1;  // image index of h_top

  extern __shared__ float smem[];
  const int sector = blockIdx.x / p.lights;  // east, west, north, south
  const int light = blockIdx.x - sector * p.lights;
  const bool ns = sector >= 2;
  const bool rev = (sector & 1) != 0;
  const int rows = ns ? p.width : p.height;
  const int cols = ns ? p.height : p.width;
  const int row_stride = ns ? 1 : p.width;  // image offset of a walk row
  const int col_stride = ns ? p.width : 1;  // and of a walk column
  const int C = p.tile_cols;
  const int P = padded_rows(rows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;

  float* tin = smem;
  float* obuf = tin + 2 * NIN * C * P;
  float* xb = obuf + (ns ? 0 : 2 * KOUT * C * P);

  // The light in the walk's frame: along the walk, across it; the
  // reversed walk's along is cols - along, rounded as the plain
  // version's `float(W) - light_x`.
  float along = ns ? p.ly[light] : p.lx[light];
  const float across = ns ? p.lx[light] : p.ly[light];
  if (rev) along = __fsub_rn((float)cols, along);
  const float radius = p.lr[light];
  const size_t plane = (size_t)p.height * p.width;
  const size_t chan = (size_t)p.lights * plane;
  float* out = p.out + (size_t)sector * KOUT * chan + (size_t)light * plane;

  float fill[NX];
  fill[0] = p.big;
  fill[1] = 0.0f;
  fill[2] = 0.0f;
  if constexpr (kFoot) fill[3] = p.big;
  if constexpr (kExtra) {
    fill[K] = p.top_fill;
    fill[K + 1] = p.bot_fill;
    fill[K + 2] = 0.0f;
  }
  float car[R][NX];
  float yc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    // (y + 0.5) - ly: the row's offset from the light across the walk.
    yc[i] = __fsub_rn(__fadd_rn((float)(tid * R + i), 0.5f), across);
#pragma unroll
    for (int v = 0; v < NX; ++v) car[i][v] = fill[v];
  }

  // Stage image columns [t C, t C + C) of every walk row, one
  // asynchronous 4-byte copy an element, coalesced along the image.
  auto load_tile = [&](int t) {
    float* dst = tin + (t & 1) * NIN * C * P;
    const int n = rows * C;
    for (int e = tid; e < n; e += blockDim.x) {
      int r, c;
      if (ns) {
        c = e / rows;
        r = e - c * rows;
      } else {
        r = e / C;
        c = e - r * C;
      }
      const int x = t * C + c;
      if (x >= cols) continue;
      const size_t off = (size_t)r * row_stride +
                         (size_t)(rev ? cols - 1 - x : x) * col_stride;
#pragma unroll
      for (int ch = 0; ch < NIN; ++ch)
        __pipeline_memcpy_async(dst + (ch * C + c) * P + r,
                                p.image[ch] + off, sizeof(float));
    }
    __pipeline_commit();
  };
  // East / west: write tile t's buffered outputs along the image rows.
  auto flush = [&](int t) {
    const float* src = obuf + (t & 1) * KOUT * C * P;
    const int n = rows * C;
    for (int e = tid; e < n; e += blockDim.x) {
      const int r = e / C;
      const int c = e - r * C;
      const int x = t * C + c;
      if (x >= cols) continue;
      const size_t pix = (size_t)r * p.width + (rev ? cols - 1 - x : x);
#pragma unroll
      for (int ch = 0; ch < KOUT; ++ch)
        out[ch * chan + pix] = src[(ch * C + c) * P + r];
    }
  };

  const int tiles = (cols + C - 1) / C;
  load_tile(0);
  for (int x = 0; x < cols; ++x) {
    const int t = x / C;
    const int c = x - t * C;
    // Publish the warp's edge rows, then one barrier.
    float* edge = xb + (x & 1) * warps * 2 * NX;
    if (lane == 0) {
#pragma unroll
      for (int v = 0; v < NX; ++v) edge[(warp * 2) * NX + v] = car[0][v];
    }
    if (lane == 31) {
#pragma unroll
      for (int v = 0; v < NX; ++v)
        edge[(warp * 2 + 1) * NX + v] = car[R - 1][v];
    }
    if (c == 0) __pipeline_wait_prior(0);
    __syncthreads();
    if (c == 0) {
      if (t + 1 < tiles) load_tile(t + 1);
      if (!ns && t > 0) flush(t - 1);
    }
    // The row above this thread's first row, and below its last.
    float above[NX], below[NX];
#pragma unroll
    for (int v = 0; v < NX; ++v) {
      above[v] = __shfl_up_sync(kFullMask, car[R - 1][v], 1);
      below[v] = __shfl_down_sync(kFullMask, car[0][v], 1);
    }
    if (lane == 0 && warp > 0) {
#pragma unroll
      for (int v = 0; v < NX; ++v)
        above[v] = edge[((warp - 1) * 2 + 1) * NX + v];
    }
    if (lane == 31 && warp + 1 < warps) {
#pragma unroll
      for (int v = 0; v < NX; ++v) below[v] = edge[((warp + 1) * 2) * NX + v];
    }

    // The fan at this column: the ray to (x, y) passes the previous
    // column at y - f, f = (y - ly) / dx clamped to [-1, 1].
    const float dx = __fsub_rn(__fadd_rn((float)x, 0.5f), along);
    const bool in_front = dx >= 1.0f;
    const bool valid = in_front && dx > radius;
    const float den = t_clamp_min(dx, 1.0f);
    const float* tile = tin + (t & 1) * NIN * C * P;
    float* ob = obuf + (t & 1) * KOUT * C * P;
    const size_t pix_ns = (size_t)(rev ? cols - 1 - x : x) * p.width;

    float nxt[R][NX];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = tid * R + i;
      const bool live = r < rows;
      const bool top_edge = r == 0;
      const bool bot_edge = r + 1 >= rows;
      const float f = t_clamp(__fdiv_rn(yc[i], den), -1.0f, 1.0f);
      const float af = fabsf(f);
      const float near = __fsub_rn(1.0f, af);
      const bool fpos = f >= 0.0f;
      float up[NX], dn[NX];
#pragma unroll
      for (int v = 0; v < NX; ++v) {
        up[v] = top_edge ? fill[v] : (i > 0 ? car[i > 0 ? i - 1 : 0][v]
                                            : above[v]);
        dn[v] = bot_edge ? fill[v]
                         : (i + 1 < R ? car[i + 1 < R ? i + 1 : 0][v]
                                      : below[v]);
      }
      float res[KOUT];
#pragma unroll
      for (int v = 0; v < K; ++v) {
        const float s = resample(car[i][v], near, fpos ? up[v] : dn[v], af);
        res[v] = in_front ? s : fill[v];
      }
      const float occ = live ? tile[c * P + r] : 0.0f;
      const float d_here = valid ? occ : p.big;
      const float new_d = t_min(res[0], d_here);
      const bool upd = d_here < res[0];
      nxt[i][0] = new_d;
      nxt[i][1] = upd ? dx : res[1];
      const float exit = t_clamp_min(__fadd_rn(new_d, p.band), p.band);
      nxt[i][2] = d_here < exit ? dx : res[2];
      if constexpr (kFoot) {
        const float fp =
            live ? tile[(C + c) * P + r] : 0.0f;
        nxt[i][3] = t_min(res[3], valid ? fp : p.big);
      }
      if constexpr (kExtra) {
        // The payload's phase-corrected shifted copy: round (f + phase);
        // the phase resets where the arg-min takes this column's data.
        const float shift =
            t_clamp(rintf(__fadd_rn(f, car[i][K + 2])), -1.0f, 1.0f);
        float src[3];
#pragma unroll
        for (int v = 0; v < 3; ++v)
          src[v] = shift > 0.5f ? up[K + v]
                                : (shift < -0.5f ? dn[K + v] : car[i][K + v]);
        float ph = __fsub_rn(__fadd_rn(src[2], f), shift);
        float ht = src[0], hb = src[1];
        if (!in_front) {
          ht = fill[K];
          hb = fill[K + 1];
          ph = fill[K + 2];
        }
        const float t_here =
            live ? tile[(kTop_in * C + c) * P + r] : 0.0f;
        const float b_here =
            live ? tile[((kTop_in + 1) * C + c) * P + r] : 0.0f;
        res[K] = ht;
        res[K + 1] = hb;
        nxt[i][K] = upd ? t_here : ht;
        nxt[i][K + 1] = upd ? b_here : hb;
        nxt[i][K + 2] = upd ? 0.0f : ph;
      }
      if (live) {
        if (ns) {
#pragma unroll
          for (int v = 0; v < KOUT; ++v) out[v * chan + pix_ns + r] = res[v];
        } else {
#pragma unroll
          for (int v = 0; v < KOUT; ++v) ob[(v * C + c) * P + r] = res[v];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int v = 0; v < NX; ++v) car[i][v] = nxt[i][v];
    }
  }
  if (!ns) {
    __syncthreads();
    flush(tiles - 1);
  }
}

typedef void (*Kernel)(const Params);

// Instances: rows a thread 1, 2, 4; footprint; extras (the order of
// scan_walk_kernel.py's `instance`).
Kernel kernel_for(int instance) {
  static const Kernel table[12] = {
      scan_walk_kernel<1, false, false>, scan_walk_kernel<1, false, true>,
      scan_walk_kernel<1, true, false>,  scan_walk_kernel<1, true, true>,
      scan_walk_kernel<2, false, false>, scan_walk_kernel<2, false, true>,
      scan_walk_kernel<2, true, false>,  scan_walk_kernel<2, true, true>,
      scan_walk_kernel<4, false, false>, scan_walk_kernel<4, false, true>,
      scan_walk_kernel<4, true, false>,  scan_walk_kernel<4, true, true>};
  return (instance >= 0 && instance < 12) ? table[instance] : nullptr;
}

cudaError_t opt_in(Kernel fn, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// ints: height, width, lights, instance, threads, tile_cols, smem bytes
// (7); floats: exit band, the no-blocker distance, the top and bottom
// fills of the payload (4). footprint, top, bot: null unless the
// instance takes them.
extern "C" int scan_walk(const float* occ, const float* footprint,
                         const float* top, const float* bot, const float* lx,
                         const float* ly, const float* lr, float* out,
                         const int* ints, const float* floats,
                         cudaStream_t stream) {
  Params p;
  const int instance = ints[3];
  const bool foot = (instance & 2) != 0;
  const bool extra = (instance & 1) != 0;
  int n = 0;
  p.image[n++] = occ;
  if (foot) p.image[n++] = footprint;
  if (extra) {
    p.image[n++] = top;
    p.image[n++] = bot;
  }
  while (n < 4) p.image[n++] = nullptr;
  p.lx = lx;
  p.ly = ly;
  p.lr = lr;
  p.out = out;
  p.height = ints[0];
  p.width = ints[1];
  p.lights = ints[2];
  p.tile_cols = ints[5];
  p.band = floats[0];
  p.big = floats[1];
  p.top_fill = floats[2];
  p.bot_fill = floats[3];
  const int threads = ints[4];
  const int smem = ints[6];
  if (p.lights <= 0 || p.height <= 0 || p.width <= 0) return 0;
  Kernel fn = kernel_for(instance);
  if (fn == nullptr || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(fn, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<4 * p.lights, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// An instance on the current card: registers and spilled (local) bytes
// a thread, the most threads a block may take, after opting in to
// `smem` bytes of shared memory.
extern "C" int scan_walk_plan(int instance, int smem, int* out) {
  Kernel fn = kernel_for(instance);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(fn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = attr.maxThreadsPerBlock;
  return 0;
}
