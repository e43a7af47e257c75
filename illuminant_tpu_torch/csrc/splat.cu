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
// A particle adds only inside its own tile's window [t T - A, t T + T + A)
// (its tile by truncation, clipped to the grid), so every particle belongs
// to exactly one tile, and a tile's window (40 x 40 x C floats at T = 32,
// A = 4) fits in shared memory. One splat is four launches on the stream,
// with scratch sized on the host from n and the grid, never from data:
//   1. bin: a thread bins 4 slots (the live and on-screen test, the tile)
//      and takes each a rank in its tile: the block counts its slots in
//      shared memory first and adds each tile's total to the device count
//      with one atomic;
//   2. scan: one block scans the counts into offsets and chunk offsets
//      (each tile's list cut into chunks of `chunk`, at most two batches,
//      so that a clustered tile spreads over many blocks) and writes the
//      chunk table (a launch of its own: the bin blocks' fences and their
//      count of finished blocks, for the last to scan, cost more);
//   3. scatter: each binned slot writes a 32-byte record (x, y, radius,
//      colour) at its tile's offset plus its rank;
//   4. accumulate: one block a chunk (the grid is ceil(n / chunk) + tiles,
//      an upper bound known without a read; blocks past the last chunk
//      exit). The block stages `batch` particles at a time: a thread a
//      particle computes its row and column profiles once, trimmed to
//      their nonzero runs. `lanes` lanes then take a particle (more while
//      the batch leaves threads idle), a lane a row of its footprint, and
//      add colour x wy x wx to the tile's window in shared memory
//      (compare-and-swap, two channels at a time where C is 2 or 4). The
//      window's nonzero sums go to the image once a chunk, a warp a row,
//      coalesced, four floats to a 16-byte vector atomic (neighbouring
//      tiles' aprons and a split tile's chunks overlap, so a plain store
//      would lose sums). A tile of at most `direct` particles (most of a
//      sparse frame's) skips the window and adds its terms to the image
//      directly, a pixel's channels with sm_90's float2 / float4 atomics.
// Nothing is read back and no bin has a capacity: no particle is dropped.
//
// What bounded the first cut (one thread a particle, each tap `channels`
// global atomics): the atomics into the image, ~120M scalar float atomics
// at the steady flagship's 1,048,576 gauss particles, many on the same
// pixels (up to 61 terms a pixel): 0.8857 ms against a 0.0153 ms byte
// bound on an H100 80GB HBM3 at 700 W. Here the terms meet in shared
// memory and the image takes at most one vector atomic per four window
// floats and chunk. What bounds this design, on the same card
// (tools/torch_march_study.py times each kernel): at 1,048,576 uniform
// gauss particles the accumulation, 0.40 of 0.50 ms, its shared-memory
// compare-and-swap loops (sm_90 has no shared-memory float add); on the
// particle cell's default frame (20,480 of 1,048,576 slots live) the
// launches and the passes over the slots: bin 0.012, scan 0.003, scatter
// 0.004, accumulate 0.009 ms, where the one-pass first cut took 0.018 ms
// with the image's zero fill (PERF.md section 6).
//
// Float atomics reorder each pixel's sum (the plain version's index_add_
// on the card is atomic too): two orders of n non-negative terms differ
// by at most n x 2^-23 x the sum, whatever tree the partial sums form.
// The weights themselves are the plain version's bit for bit: the file is
// compiled with -fmad=false and each profile keeps tiled._profile's
// operation order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // every launch of the sequence
constexpr int kWarps = kThreads / 32;
constexpr int kBinPerThread = 4;  // slots a thread bins
constexpr int kScanThreads = 1024;  // the scan's one block
constexpr int kMaxLanes = 16;     // lanes a particle at most (a row each)
constexpr int kBinSlots = kThreads * kBinPerThread;
// The most tiles whose counts a bin block keeps in shared memory: the
// 48 KB a launch may use without opting in.
constexpr int kBlockCountTiles = 48 * 1024 / 4;

// tiled.py's kernel names, in the wrapper's KERNELS order.
enum Kind { kPoint = 0, kQuad = 1, kGauss = 2, kRound = 3 };

struct Splat {
  const float* x;
  const float* y;
  const float* size;
  const unsigned char* live;
  const float* color;
  long long sx, sy, ssize, slive, scolor_row, scolor_col;
  int n;
  float* image;  // (H * W, C)
  int height, width, tile, apron, grid_y, grid_x, channels, kind, chunk;
  int batch;         // particles an accumulation block stages at a time
  int taps;          // the most taps a profile spans (scratch a particle)
  int direct;        // tiles of at most this many: no window, direct adds
  int lanes;         // lanes that share a particle, a row each (1, 2, 4)
  int block_counts;  // tiles <= kBlockCountTiles: bin blocks count first
};

// The scratch of one splat (the wrapper's torch.empty tensors).
struct Bins {
  int* counts;       // (tiles,): the tile counts
  int* offsets;      // (tiles + 1,): exclusive scan of the counts
  int* chunk_off;    // (tiles + 1,): exclusive scan of ceil(count / chunk)
  int* chunk_tile;   // (ceil(n / chunk) + tiles,): each chunk's tile
  int2* slots;       // (n,): (tile or -1, rank in the tile)
  float4* records;   // (n, 2): x, y, radius, 0 | colour, in tile order
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

// The tile on one axis by truncation (the JAX int cast), clipped.
__device__ __forceinline__ int tile_of(float p, int tile, int g) {
  return min(max(__float2int_rz(p / (float)tile), 0), g - 1);
}

// --------------------------------------------------------- 1. bin, 2. scan

// A tile's chunks.
__device__ __forceinline__ int tile_chunks(const Splat& s, int count) {
  return (count + s.chunk - 1) / s.chunk;
}

// The exclusive scans of the tile counts (offsets) and of their chunks
// (chunk offsets), each thread over a contiguous run (two tiles at
// 1080p), and the chunk table: one block.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(Splat s,
                                                            Bins b) {
  __shared__ int warp_sum[2][kScanThreads / 32];
  const int tiles = s.grid_y * s.grid_x;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = min((int)threadIdx.x * per, tiles);
  const int t1 = min(t0 + per, tiles);
  int n_sum = 0, c_sum = 0;
  for (int t = t0; t < t1; ++t) {
    const int c = b.counts[t];
    n_sum += c;
    c_sum += tile_chunks(s, c);
  }
  // Inclusive scans across the block: in the warp, then of warp totals.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n_inc = n_sum, c_inc = c_sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, n_inc, o);
    const int c = __shfl_up_sync(0xffffffffu, c_inc, o);
    if (lane >= o) {
      n_inc += a;
      c_inc += c;
    }
  }
  if (lane == 31) {
    warp_sum[0][warp] = n_inc;
    warp_sum[1][warp] = c_inc;
  }
  __syncthreads();
  int n_base = 0, c_base = 0;
  for (int w = 0; w < warp; ++w) {
    n_base += warp_sum[0][w];
    c_base += warp_sum[1][w];
  }
  int n_run = n_base + n_inc - n_sum, c_run = c_base + c_inc - c_sum;
  for (int t = t0; t < t1; ++t) {
    const int c = b.counts[t];
    const int chunks = tile_chunks(s, c);
    b.offsets[t] = n_run;
    b.chunk_off[t] = c_run;
    for (int j = 0; j < chunks; ++j) b.chunk_tile[c_run + j] = t;
    n_run += c;
    c_run += chunks;
  }
  if (threadIdx.x == kScanThreads - 1) {
    b.offsets[tiles] = n_run;
    b.chunk_off[tiles] = c_run;
  }
}

// Slot i's liveness (false past the last slot).
__device__ __forceinline__ bool slot_live(const Splat& s, int i) {
  return i < s.n && __ldg(s.live + i * s.slive);
}

// Live slot i's tile, or -1 where it is off-screen.
__device__ __forceinline__ int slot_tile(const Splat& s, int i) {
  const float x = __ldg(s.x + i * s.sx);
  const float y = __ldg(s.y + i * s.sy);
  const float a1 = (float)s.apron + 1.0f;
  if (!((x > -a1) && (x < (float)s.width + a1) && (y > -a1) &&
        (y < (float)s.height + a1)))
    return -1;
  return tile_of(y, s.tile, s.grid_y) * s.grid_x +
         tile_of(x, s.tile, s.grid_x);
}

// Adds the warp's lanes of each distinct tile to counts[tile] with one
// atomic (the lowest lane's) and returns each lane's rank among them plus
// the count before it.
__device__ __forceinline__ int warp_rank(int* counts, int tile) {
  const unsigned binned = __ballot_sync(0xffffffffu, tile >= 0);
  int rank = 0;
  if (tile >= 0) {
    const unsigned peers = __match_any_sync(binned, tile);
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(counts + tile, __popc(peers));
    base = __shfl_sync(peers, base, leader);
    rank = base + __popc(peers & ((1u << lane) - 1u));
  }
  return rank;
}

// A block bins kBinSlots slots. Where the grid's counts fit in shared
// memory, the block counts its slots there first and adds each tile's
// total to the device count with one atomic: particles spawned together
// share tiles, so a block makes a few device atomics, not one a warp and
// tile.
__global__ void __launch_bounds__(kThreads) bin_kernel(Splat s, Bins b) {
  extern __shared__ int hist[];  // (tiles,) when s.block_counts
  const int tiles = s.grid_y * s.grid_x;
  const int i0 = blockIdx.x * kBinSlots + threadIdx.x;
  int tile[kBinPerThread], rank[kBinPerThread];
  bool live[kBinPerThread];
  // Every liveness byte first, then the live slots' positions: the loads
  // of a thread's slots are in flight together.
#pragma unroll
  for (int k = 0; k < kBinPerThread; ++k)
    live[k] = slot_live(s, i0 + k * kThreads);
#pragma unroll
  for (int k = 0; k < kBinPerThread; ++k)
    tile[k] = live[k] ? slot_tile(s, i0 + k * kThreads) : -1;
  if (s.block_counts) {
    for (int t = threadIdx.x; t < tiles; t += kThreads) hist[t] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBinPerThread; ++k) rank[k] = warp_rank(hist, tile[k]);
    __syncthreads();
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      const int c = hist[t];
      if (c > 0) hist[t] = atomicAdd(b.counts + t, c);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBinPerThread; ++k)
      if (tile[k] >= 0) rank[k] += hist[tile[k]];
  } else {
#pragma unroll
    for (int k = 0; k < kBinPerThread; ++k)
      rank[k] = warp_rank(b.counts, tile[k]);
  }
#pragma unroll
  for (int k = 0; k < kBinPerThread; ++k) {
    const int i = i0 + k * kThreads;
    if (i < s.n) b.slots[i] = make_int2(tile[k], rank[k]);
  }
}

// ------------------------------------------------------------ 3. scatter

// Each binned slot writes its 32-byte record (x, y, radius, colour) at its
// tile's offset plus its rank: the tile's particles in order.
__global__ void __launch_bounds__(kThreads) scatter_kernel(Splat s, Bins b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= s.n) return;
  const int2 slot = b.slots[i];
  if (slot.x < 0) return;
  const float r = fminf(fmaxf(__ldg(s.size + i * s.ssize) * 0.5f, 0.5f),
                        (float)s.apron + 0.5f);
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  c.x = __ldg(s.color + i * s.scolor_row);
  if (s.channels > 1) c.y = __ldg(s.color + i * s.scolor_row + s.scolor_col);
  if (s.channels > 2)
    c.z = __ldg(s.color + i * s.scolor_row + 2 * s.scolor_col);
  if (s.channels > 3)
    c.w = __ldg(s.color + i * s.scolor_row + 3 * s.scolor_col);
  const int dst = __ldg(b.offsets + slot.x) + slot.y;
  b.records[2 * (size_t)dst] =
      make_float4(__ldg(s.x + i * s.sx), __ldg(s.y + i * s.sy), r, 0.0f);
  b.records[2 * (size_t)dst + 1] = c;
}

// --------------------------------------------------------- 4. accumulate

// A window row's floats: `side` pixels of C floats and 4 more, so that the
// lanes on neighbouring rows of one column meet other banks.
__host__ __device__ __forceinline__ int window_pitch(int side, int C) {
  return side * C + 4;
}

// A window's floats (a multiple of 4: what follows is 16-byte aligned).
__host__ __device__ __forceinline__ size_t window_floats(int side, int C) {
  return (size_t)side * window_pitch(side, C);
}

// The accumulation's shared memory: the window (C floats a pixel), then a
// batch's headers
// (colour; window-local first column, columns, first row, rows; its two
// profiles' offsets) and profiles (2 x taps floats a particle).
__host__ __device__ __forceinline__ size_t accumulate_smem(int batch,
                                                           int taps, int side,
                                                           int C) {
  return sizeof(float) * window_floats(side, C) +
         (size_t)batch * (sizeof(float4) + sizeof(int4) + sizeof(int2)) +
         sizeof(float) * (size_t)batch * 2 * taps;
}

// One particle's profiles over its clipped footprint, kept from the first
// to the last nonzero tap (a profile is nonzero on one run of taps): ->
// the run's first tap, its length, written from prof[first].
__device__ __forceinline__ void profile_run(int kind, float p, float r,
                                            int lo, int n, float* prof,
                                            int* first, int* len) {
  int a = n, z = -1;
  for (int q = 0; q < n; ++q) {
    const float w = profile(kind, (float)(lo + q) + 0.5f - p, r);
    prof[q] = w;
    if (w != 0.0f) {
      a = min(a, q);
      z = q;
    }
  }
  *first = a;
  *len = z - a + 1;
}

// One particle's header and profiles from its record: its clipped
// footprint in the window (xlo, ylo)-(xhi, yhi) and both profiles, each
// tap's once, trimmed to their nonzero runs, into staging slot j.
__device__ __forceinline__ void stage_particle(
    const Splat& s, float4 a, float4 color, int j, int xlo, int xhi, int ylo,
    int yhi, float4* hdr_c, int4* hdr_g, int2* hdr_o, float* prof) {
  const float x = a.x, y = a.y, r = a.z;
  const int k = (int)ceilf(support(s.kind, r)) + 1;
  const int fx = (int)floorf(x), fy = (int)floorf(y);
  const int px0 = max(fx - k, xlo), px1 = min(fx + k, xhi - 1);
  const int py0 = max(fy - k, ylo), py1 = min(fy + k, yhi - 1);
  float* wx = prof + (size_t)j * 2 * s.taps;
  float* wy = wx + s.taps;
  int fx0 = 0, nx = 0, fy0 = 0, ny = 0;
  if (px1 >= px0 && py1 >= py0) {
    profile_run(s.kind, x, r, px0, px1 - px0 + 1, wx, &fx0, &nx);
    profile_run(s.kind, y, r, py0, py1 - py0 + 1, wy, &fy0, &ny);
  }
  if (nx <= 0) ny = 0;  // nothing to add: no pixel reached
  hdr_c[j] = color;
  hdr_g[j] = make_int4(px0 + fx0 - xlo, nx, py0 + fy0 - ylo, ny);
  hdr_o[j] = make_int2(j * 2 * s.taps + fx0, j * 2 * s.taps + s.taps + fy0);
}

// *p += a (and p[1] += b where Pair): one shared-memory compare-and-swap
// loop of 32 or 64 bits, each float added as atomicAdd adds it.
template <bool Pair>
__device__ __forceinline__ void add_shared(float* p, float a, float b) {
  if (!Pair) {
    atomicAdd(p, a);
    return;
  }
  unsigned long long* q = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *q, seen;
  do {
    seen = old;
    const float x = __uint_as_float((unsigned)seen) + a;
    const float y = __uint_as_float((unsigned)(seen >> 32)) + b;
    old = atomicCAS(q, seen,
                    ((unsigned long long)__float_as_uint(y) << 32) |
                        __float_as_uint(x));
  } while (old != seen);
}

// v added to the image's C floats at dst with sm_90's vector atomics: C
// = 2 and 4 one each; C = 3 a pair at the 8-byte-aligned end and a float
// at the other (the image is 16-byte aligned).
template <int C>
__device__ __forceinline__ void add_image(float* dst, float4 v) {
  if (C == 1) {
    atomicAdd(dst, v.x);
  } else if (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v.x, v.y));
  } else if (C == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
  } else if ((reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v.x, v.y));
    atomicAdd(dst + 2, v.z);
  } else {
    atomicAdd(dst, v.x);
    atomicAdd(reinterpret_cast<float2*>(dst + 1), make_float2(v.y, v.z));
  }
}

// One particle's term colour x w at a pixel of C floats: of the window in
// shared memory, or of the image in device memory.
template <int C, bool Shared>
__device__ __forceinline__ void add_term(float* dst, float w, float4 c) {
  if (Shared) {
    if (C == 1) {
      add_shared<false>(dst, w * c.x, 0.0f);
    } else {
      if (C == 3) {
        add_shared<false>(dst, w * c.x, 0.0f);
        add_shared<false>(dst + 1, w * c.y, 0.0f);
        add_shared<false>(dst + 2, w * c.z, 0.0f);
      } else {
        add_shared<true>(dst, w * c.x, w * c.y);
        if (C == 4) add_shared<true>(dst + 2, w * c.z, w * c.w);
      }
    }
  } else {
    add_image<C>(dst, make_float4(w * c.x, w * c.y, w * c.z, w * c.w));
  }
}

// The batch's m staged particles: `lanes` lanes a particle, or more (up
// to kMaxLanes) while the block's threads outnumber the lanes, a lane a
// row of its nonzero footprint, each term added at `out` (the window's
// first pixel; `pitch` floats a row, C a pixel).
template <int C, bool Shared>
__device__ __forceinline__ void add_batch(int m, int lanes,
                                          const int4* hdr_g,
                                          const int2* hdr_o,
                                          const float4* hdr_c,
                                          const float* prof, float* out,
                                          long long pitch) {
  while (lanes < kMaxLanes && 2 * lanes * m <= kThreads) lanes *= 2;
  const int lane = threadIdx.x & (lanes - 1);
  for (int j = threadIdx.x / lanes; j < m; j += kThreads / lanes) {
    const int4 g = hdr_g[j];  // first column, columns, first row, rows
    const int2 o = hdr_o[j];
    const float4 cv = hdr_c[j];
    for (int iy = lane; iy < g.w; iy += lanes) {
      const float wy = prof[o.y + iy];
      float* dst = out + (g.z + iy) * pitch + (long long)g.x * C;
      for (int ix = 0; ix < g.y; ++ix) {
        const float w = wy * prof[o.x + ix];
        if (w != 0.0f) add_term<C, Shared>(dst + ix * C, w, cv);
      }
    }
  }
}

// One block a chunk of up to s.chunk particles of one tile's list, staged
// s.batch at a time. The block sums the chunk's terms in its tile's window
// in shared memory (s.lanes lanes a particle, a lane a row of its nonzero
// footprint, its profiles computed once, at staging, the terms added with
// shared-memory compare-and-swap, two channels at a time where C is 2 or
// 4). Then the
// window's nonzero sums go to the image, a warp a row, coalesced, one
// atomic each. A tile of at most s.direct particles skips the window: its
// terms go to the image directly, one atomic each.
template <int C>
__global__ void __launch_bounds__(kThreads, 4)
    accumulate_kernel(Splat s, Bins b) {
  extern __shared__ float4 smem4[];
  const int side = s.tile + 2 * s.apron;
  float* win = (float*)smem4;  // side rows of `pitch`, the clipped origin
  const int pitch = window_pitch(side, C);
  float4* hdr_c = (float4*)(win + window_floats(side, C));
  int4* hdr_g = (int4*)(hdr_c + s.batch);
  int2* hdr_o = (int2*)(hdr_g + s.batch);
  float* prof = (float*)(hdr_o + s.batch);

  const int tiles = s.grid_y * s.grid_x;
  const int bi = blockIdx.x;
  if (bi >= __ldg(b.chunk_off + tiles)) return;
  const int t = __ldg(b.chunk_tile + bi);
  const int begin =
      __ldg(b.offsets + t) + (bi - __ldg(b.chunk_off + t)) * s.chunk;
  const int end = min(begin + s.chunk, __ldg(b.offsets + t + 1));
  const bool windowed = __ldg(b.counts + t) > s.direct;
  const int ty = t / s.grid_x, tx = t - ty * s.grid_x;
  const int xlo = max(tx * s.tile - s.apron, 0);
  const int xhi = min(tx * s.tile + s.tile + s.apron, s.width);
  const int ylo = max(ty * s.tile - s.apron, 0);
  const int yhi = min(ty * s.tile + s.tile + s.apron, s.height);

  if (windowed) {
    const int n4 = (int)(window_floats(side, C) / 4);
    for (int k = threadIdx.x; k < n4; k += kThreads)
      smem4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float* image_at = s.image + ((long long)ylo * s.width + xlo) * C;
  for (int base = begin; base < end; base += s.batch) {
    const int m = min(s.batch, end - base);
    if ((int)threadIdx.x < m) {
      const size_t q = base + threadIdx.x;
      stage_particle(s, b.records[2 * q], b.records[2 * q + 1], threadIdx.x,
                     xlo, xhi, ylo, yhi, hdr_c, hdr_g, hdr_o, prof);
    }
    __syncthreads();  // the window is clear, the batch staged
    if (windowed)
      add_batch<C, true>(m, s.lanes, hdr_g, hdr_o, hdr_c, prof, win, pitch);
    else
      add_batch<C, false>(m, s.lanes, hdr_g, hdr_o, hdr_c, prof, image_at,
                          (long long)s.width * C);
    __syncthreads();  // the staging is rewritten next
  }
  if (!windowed) return;

  // A warp a row: the floats up to the image's first 16-byte boundary
  // and after its last one alone, those between four at a time, each
  // four with one vector atomic unless all are 0.
  const int warp = threadIdx.x >> 5, lane32 = threadIdx.x & 31;
  const int row_floats = (xhi - xlo) * C;
  for (int ry = warp; ry < yhi - ylo; ry += kWarps) {
    float* out = image_at + (long long)ry * s.width * C;
    const float* in = win + ry * pitch;
    const int head = min(
        (int)((4 - (reinterpret_cast<uintptr_t>(out) >> 2)) & 3), row_floats);
    const int quads = (row_floats - head) >> 2;
    const int body = head + 4 * quads;
    for (int rx = lane32; rx < row_floats - 4 * quads; rx += 32) {
      const int at = rx < head ? rx : body + rx - head;
      const float v = in[at];
      if (v != 0.0f) atomicAdd(out + at, v);
    }
    for (int q = lane32; q < quads; q += 32) {
      const float* v = in + head + 4 * q;
      const float4 f = make_float4(v[0], v[1], v[2], v[3]);
      if (f.x != 0.0f || f.y != 0.0f || f.z != 0.0f || f.w != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(out + head) + q, f);
    }
  }
}

// Each channel count's accumulation kernel.
const void* accumulate_fn(int channels) {
  switch (channels) {
    case 1:
      return (const void*)accumulate_kernel<1>;
    case 2:
      return (const void*)accumulate_kernel<2>;
    case 3:
      return (const void*)accumulate_kernel<3>;
    default:
      return (const void*)accumulate_kernel<4>;
  }
}

// An accumulation kernel may use `smem` bytes of dynamic shared memory,
// and prefers the SM's unified memory as shared memory: its blocks are
// bound by it.
cudaError_t opt_in(const void* fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || smem <= 48 * 1024) return err;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// ptrs: x, y, size, live (1 byte a particle), color, image, then the
//       scratch: bins (tiles + 2 x (tiles + 1) + ceil(n / chunk) + tiles
//       int32),
//       slots (n x 2 int32), records (n x 8 float32).
// strides: x, y, size, live, color row, color column (elements).
// ints: n, height, width, tile, apron, grid_y, grid_x, channels, kind,
//       chunk, batch (at most kThreads), taps, direct, lanes.
// Four launches on `stream`; `launched` gets how many were made.
extern "C" int splat(const void* const* ptrs, const long long* strides,
                     const long long* ints, int* launched, void* stream) {
  *launched = 0;
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
  s.n = (int)ints[0];
  s.height = (int)ints[1];
  s.width = (int)ints[2];
  s.tile = (int)ints[3];
  s.apron = (int)ints[4];
  s.grid_y = (int)ints[5];
  s.grid_x = (int)ints[6];
  s.channels = (int)ints[7];
  s.kind = (int)ints[8];
  s.chunk = (int)ints[9];
  s.batch = (int)ints[10];
  s.taps = (int)ints[11];
  s.direct = (int)ints[12];
  s.lanes = (int)ints[13];
  const int tiles = s.grid_y * s.grid_x;
  s.block_counts = tiles <= kBlockCountTiles;
  if (s.channels < 1 || s.channels > 4 || s.kind < 0 || s.kind > 3 ||
      s.chunk < 1 || s.batch < 1 || s.batch > kThreads || s.taps < 1 ||
      !(s.lanes == 1 || s.lanes == 2 || s.lanes == 4) ||
      ints[0] >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if (s.n <= 0) return 0;
  Bins b;
  b.counts = (int*)ptrs[6];
  b.offsets = b.counts + tiles;
  b.chunk_off = b.offsets + tiles + 1;
  b.chunk_tile = b.chunk_off + tiles + 1;
  b.slots = (int2*)ptrs[7];
  b.records = (float4*)ptrs[8];
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = accumulate_smem(s.batch, s.taps, s.tile + 2 * s.apron,
                                     s.channels);
  cudaError_t err;
  if ((err = opt_in(accumulate_fn(s.channels), smem)) != cudaSuccess)
    return (int)err;
  err = cudaMemsetAsync(b.counts, 0, sizeof(int) * tiles, st);
  if (err != cudaSuccess) return (int)err;
  bin_kernel<<<(unsigned int)((s.n + kBinSlots - 1) / kBinSlots), kThreads,
               s.block_counts ? sizeof(int) * tiles : 0, st>>>(s, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  scan_kernel<<<1, kScanThreads, 0, st>>>(s, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 2;
  scatter_kernel<<<blocks_for(s.n), kThreads, 0, st>>>(s, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 3;
  const long long chunks = (s.n + (long long)s.chunk - 1) / s.chunk + tiles;
  void* args[] = {&s, &b};
  err = cudaLaunchKernel(accumulate_fn(s.channels),
                         dim3((unsigned int)chunks), dim3(kThreads), args,
                         smem, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 4;
  return 0;
}

// The accumulation's block on this card for `batch` particles staged at
// a time, profiles of up to `taps` taps, a `side`-pixel window of
// `channels`: threads, dynamic shared memory, registers a thread, spilled
// bytes, resident blocks an SM.
extern "C" int splat_plan(int batch, int taps, int side, int channels,
                          int* out) {
  const size_t smem = accumulate_smem(batch, taps, side, channels);
  const void* fn = accumulate_fn(channels);
  cudaError_t err = opt_in(fn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = blocks;
  return 0;
}
