// Tile compositor and additive sprite splat for Hopper (sm_90a).
//
// Replaces the XLA stages of illuminant_tpu/raster/tiled.py:
// composite_over_tiles (a lax.scan over bin slots: every slot step updates
// every tile's (win, win, 4) image from one-hot coverage factors) and the
// additive splat of illuminant_tpu/raster/sprites.py:rasterize_sprites
// (rank-R one-hot matmuls per tile, then an overlap-add of the tile
// windows). Two kernels on shared device functions:
//   * composite_kernel (K11a): the ordered "over" of a tile's binned
//     particles in draw order, with an analytic profile (quad, gauss,
//     round: tiled._profile) or a sprite table's rank-R factors, the Bayer
//     dither, the opacity folded into each record's alpha, and the
//     background "over" fused in as the epilogue;
//   * accumulate_kernel (K11b): the additive sprite coverage: each pixel
//     sums the particles binned to its own tile and to its 8 neighbours
//     whose windows (the tile plus `apron`) cover it.
//
// Layout: one block per screen tile of t x t pixels (t <= 32, a multiple
// of 4), t * t / 4 threads (256 at t = 32) rounded up to whole warps; a
// thread owns 4 rows of one column, so at t = 32 a warp is a strip of 4
// rows x 32 columns. The block walks its list in chunks of `chunk`
// particles (16 at rank 4), each in three steps: fetch (a thread loads one
// particle's index and 8-float record into registers; `put` stores it
// with the particle's placement on each axis), stage (one warp per
// (particle, axis), one lane per tile line, writes the particle's
// separable factors, one value a rank for each of the tile's rows and
// columns, into shared memory, and a ballot gives the bit mask of the
// lines where a factor is nonzero), composite (each thread runs the chunk
// in order on its 4 pixels from registers). Both kernels are compiled for
// ranks 1 and 4 and for any rank, the composite with and without dither,
// so that the common cases' loops unroll and their branches fold.
//
// What bounds them on an H100, and what the design does about it:
//   * Instructions and latency, not bytes. The image and the lists are
//     ~72 MB at the 1080p cells (0.02 ms at 3.35 TB/s), but every
//     (particle, pixel) pair of a listed footprint takes a few tens of
//     instructions: the float operations run one by one (-fmad=false,
//     below) and a warp runs them for its whole 4-row strip, lanes outside
//     the footprint idle. Staging a chunk (the chain ids ->
//     record -> table, the factors, the barrier) costs about as much
//     again. So the chunks are pipelined: while a block composites chunk
//     k it stages chunk k + 1's factors and has chunk k + 2's records in
//     flight (kRecBufs record buffers, two factor buffers, one barrier a
//     chunk); the sprite table is copied into shared memory once per
//     block (a table above kTableSmemBytes is read from global memory);
//     and a block stays within 64 registers a thread and ~56 KB of shared
//     memory, so that four are resident on an SM and one block's staging
//     hides behind another's compositing. A thread skips a particle whose
//     factors vanish on all its 4 rows (uniform across a warp at t = 32)
//     or on its column.
//   * The longest lists. Each pixel's list runs in order in one thread, as
//     bit equality needs, so the fullest tile's list sets a floor that
//     more blocks cannot lower, and the tiles of a frame's crowded region
//     would start late if blocks took tiles in screen order. A block
//     takes its tile by the class of its list's length, longest first
//     (`block_tile`), so that the long lists start in the first wave. Every
//     block reads every tile's length for that, so a grid of more than
//     kOrderSpan tiles a thread (4,096 at t = 32) takes them in screen
//     order.
//   * K11b: most of the neighbour lists miss the tile. Before staging, the
//     block reads x and y of every entry of its 3 x 3 neighbourhood and
//     keeps, in the kernel's order (neighbour row, tile, list), only the
//     particles whose footprint, clipped to their own tile's window and to
//     the image, meets this tile: the test of the plain version's `ok`
//     mask (mirrored in raster/tile_kernel.py:accumulate_filter_reference).
//     A warp ballot and a prefix over the warps compact the kept entries
//     into the wrapper's scratch buffer (9 slots of the list's length; a
//     block writes only its own part of a slot, so no atomics), which the
//     pipeline then walks.
//
// Rounding: the file is compiled with -fmad=false and follows the plain
// versions' operation order (raster/tile_kernel.py:
// composite_over_tiles_reference, sprite_accumulate_reference), so the
// composite equals its plain version bit for bit (division is IEEE on both
// sides; a skipped pair adds exactly nothing). The additive splat sums a
// pixel's particles in a fixed order (the same on every call) other than
// the plain version's scatter, so it agrees to float32 reordering, not
// bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 32;
constexpr int kMaxThreads = kMaxTile * kMaxTile / 4;
// The factor floats of one chunk (both axes): a chunk is kStageFloats /
// (2 * ranks * tile) particles, at most kMaxChunk and one a thread.
constexpr int kStageFloats = 4096;
constexpr int kMaxChunk = 64;
constexpr int kAhead = 2;  // chunks whose records are in flight
constexpr int kRecBufs = kAhead + 1;  // record buffers
// A sprite table of more bytes is read from global memory.
constexpr int kTableSmemBytes = 64 * 1024;
constexpr int kMaxRank = 64;
constexpr int kRecord = 8;  // x, y, c0, c1, c2, c3, radius, variant
// A list entry's source tile as (dy + 1) * 3 + dx + 1 from the block's.
constexpr int kCentre = 4;
constexpr int kCodeBits = 4;
// Classes of list length for the order of the tiles: 4 an octave.
constexpr int kOrderBins = 128;
constexpr int kOrderWords = kOrderBins + 32 + 4;
// Tiles a thread scans at most to order them: above kOrderSpan x the
// block's threads, blocks take the tiles in screen order.
constexpr int kOrderSpan = 16;

enum Kind { kQuad = 0, kGauss = 1, kRound = 2, kSprite = 3 };

struct Raster {
  int height, width, tile, apron, gx, gy;
};

struct Table {
  const float* rows;  // (B, R, S) row factors
  const float* cols;  // (B, R, S) column factors
  int variants, rank, support;
};

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// tiled._profile: 1-D coverage at signed distance d from the centre.
__device__ __forceinline__ float profile(int kind, float d, float radius) {
  if (kind == kQuad) return clamp01((radius - fabsf(d)) + 0.5f);
  if (kind == kGauss) {
    const float sigma = fmaxf(radius * 0.5f, (float)0.3);
    const float t = d / sigma;
    const float q = 0.5f * (t * t);
    const float base = fmaxf(1.0f - q * 0.125f, 0.0f);
    const float b2 = base * base;
    const float b4 = b2 * b2;
    return b4 * b4;
  }
  const float t = clamp01((radius - fabsf(d)) + 0.5f);
  const float edge = clamp01(fabsf(d) / fmaxf(radius, 0.5f));
  const float u = edge * edge;
  return t * ((float)0.99924356 -
              ((float)0.24155038 + (float)0.04961871 * u) * u);
}

// The factors of one particle on one axis at window row (or column) `w` of
// the window of the tile the particle is binned to: one value a rank into
// dst[0], dst[stride], ...; 0 outside the window. `at` is the particle's
// placement on the axis (`put`): y the window-local centre u = (pos -
// org) + apron of a profile, or floor(u - 0.5) of a sprite, z the
// fraction u - 0.5 - floor(u - 0.5), w the offset of its variant's
// factors in `table_axis` (shared or global memory); `q` its record.
// Returns whether any is nonzero.
__device__ __forceinline__ bool factors(int kind, const Table& tab,
                                        int ranks, float4 at, const float* q,
                                        int w, int win,
                                        const float* table_axis, float* dst,
                                        int stride) {
  if (w < 0 || w >= win) {
    for (int r = 0; r < ranks; ++r) dst[r * stride] = 0.0f;
    return false;
  }
  if (kind != kSprite) {
    // tiled._coverage_factors: sample at w + 0.5.
    const float d = ((float)w + 0.5f) - at.y;
    const float v = profile(kind, d, q[6]);
    dst[0] = v;
    return v != 0.0f;
  }
  // sprites._sprite_bins_and_factors: the factor at tap s lerped with the
  // fraction f.
  const float f = at.z;
  const int half = tab.support / 2;
  const int dd = w - (int)at.y;
  const int s1 = dd - 1 + half;
  const int s2 = dd + half;
  const bool ok1 = s1 >= 0 && s1 < tab.support;
  const bool ok2 = s2 >= 0 && s2 < tab.support;
  const float* fr = table_axis + __float_as_int(at.w);
  bool any = false;
  for (int r = 0; r < ranks; ++r) {
    const float c1 = ok1 ? f * fr[r * tab.support + s1] : 0.0f;
    const float c2 = ok2 ? (1.0f - f) * fr[r * tab.support + s2] : 0.0f;
    const float v = c1 + c2;
    dst[r * stride] = v;
    any |= v != 0.0f;
  }
  return any;
}

// Shared memory of a block, in 4-byte words from a 16-byte aligned base.
struct Smem {
  float* table;    // [table_floats] the sprite table (rows, then cols)
  float* fac;      // [2 buffers][2 axes][chunk][ranks][tile]
  float* rec;      // [kRecBufs][chunk][kRecord]
  float* at;       // [kRecBufs][chunk][2 axes][4] placements (`put`)
  unsigned* mask;  // [2 buffers][chunk][2 axes] lines with a nonzero factor
  int* counts;     // [2][3][warps] the filter's kept entries per warp
  int* order;      // [kOrderWords] the block's tile, by list length
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ size_t smem_words(int table_floats,
                                                      int chunk, int ranks,
                                                      int tile, int warps) {
  return (size_t)round4(table_floats) + 4 * chunk * ranks * tile +
         kRecBufs * chunk * (kRecord + 8) + 4 * chunk + 6 * warps +
         kOrderWords;
}

__device__ __forceinline__ Smem carve(int table_floats, int chunk, int ranks,
                                      int tile) {
  extern __shared__ __align__(16) float smem[];
  Smem s;
  s.table = smem;
  s.fac = s.table + round4(table_floats);
  s.rec = s.fac + 4 * chunk * ranks * tile;
  s.at = s.rec + kRecBufs * chunk * kRecord;
  s.mask = reinterpret_cast<unsigned*>(s.at + kRecBufs * chunk * 8);
  s.counts = reinterpret_cast<int*>(s.mask + 4 * chunk);
  s.order = s.counts + 6 * (blockDim.x >> 5);
  return s;
}

// What every step of a block's walk reads.
struct Walk {
  Raster g;
  int kind, ranks, chunk;
  Table tab;  // rows / cols point at the shared copy where there is one
  Smem s;
  int ty, tx;  // the block's tile
};

// Copies the sprite table into shared memory (the caller's barrier makes
// it visible) and points w.tab at the copy.
__device__ __forceinline__ void load_table(Walk& w, int table_floats) {
  if (table_floats == 0) return;
  const int half = table_floats / 2;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    w.s.table[i] = __ldg(w.tab.rows + i);
    w.s.table[half + i] = __ldg(w.tab.cols + i);
  }
  w.tab.rows = w.s.table;
  w.tab.cols = w.s.table + half;
}

// One particle's record in flight to shared memory.
struct Fetched {
  float v[kRecord];
  int code;
};

// Chunk c's particle `threadIdx.x`, if there is one: its list entry, then
// its record, into registers.
template <class List>
__device__ __forceinline__ Fetched fetch(const Walk& w, const List& list,
                                         const float* rec, int c, int n) {
  Fetched f;
  f.code = kCentre;
  const int j = c * w.chunk + threadIdx.x;
  if (threadIdx.x < w.chunk && j < n) {
    int pid;
    list(j, pid, f.code);
    const float* q = rec + (size_t)pid * kRecord;
#pragma unroll
    for (int i = 0; i < kRecord; ++i) f.v[i] = __ldg(q + i);
  }
  return f;
}

// Puts a fetched particle into record buffer c % kRecBufs with its
// placement on each axis of its source tile's window, computed once here
// for the 32 lanes that stage it: the window position of the block's
// tile's line 0, the window-local centre u = (pos - org) + apron, or a
// sprite's floor(u - 0.5) and fraction, and its variant's offset.
__device__ __forceinline__ void put(const Walk& w, const Fetched& f, int c,
                                    int n) {
  const int j = c * w.chunk + threadIdx.x;
  if (threadIdx.x < w.chunk && j < n) {
    const int slot = (c % kRecBufs) * w.chunk + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kRecord; ++i) w.s.rec[slot * kRecord + i] = f.v[i];
    const int t = w.g.tile;
    const int a = w.g.apron;
    int variant = 0;
    if (w.kind == kSprite) {
      variant = min(max((int)f.v[7], 0), w.tab.variants - 1) * w.ranks *
                w.tab.support;
    }
#pragma unroll
    for (int axis = 0; axis < 2; ++axis) {
      const int d = axis ? f.code % 3 - 1 : f.code / 3 - 1;
      const int own = axis ? w.tx : w.ty;
      const float org = (float)((own + d) * t);
      float lo = (f.v[axis ? 0 : 1] - org) + (float)a;
      float frac = 0.0f;
      if (w.kind == kSprite) {
        const float p = lo - 0.5f;
        lo = floorf(p);
        frac = p - lo;
      }
      // This tile's line l is line (own - src) * t + apron + l of the
      // source tile's window.
      *reinterpret_cast<float4*>(w.s.at + (slot * 2 + axis) * 4) =
          make_float4(__int_as_float(a - d * t), lo, frac,
                      __int_as_float(variant));
    }
  }
}

// Chunk c's factors on the block's tile into factor buffer c & 1: one warp
// a (particle, axis), one lane a tile line, the line mask by ballot.
__device__ __forceinline__ void stage(const Walk& w, int c, int n) {
  const int m = min(w.chunk, n - c * w.chunk);
  const int b = c & 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int t = w.g.tile;
  const int a = w.g.apron;
  const int win = t + 2 * a;
  for (int pair = warp; pair < 2 * m; pair += warps) {
    const int p = pair >> 1;
    const int axis = pair & 1;  // 0: rows, 1: columns
    const int slot = (c % kRecBufs) * w.chunk + p;
    const float4 at =
        *reinterpret_cast<const float4*>(w.s.at + (slot * 2 + axis) * 4);
    float* dst = w.s.fac + (((b * 2 + axis) * w.chunk + p) * w.ranks) * t;
    bool any = false;
    if (lane < t)
      any = factors(w.kind, w.tab, w.ranks, at, w.s.rec + slot * kRecord,
                    __float_as_int(at.x) + lane, win,
                    axis ? w.tab.cols : w.tab.rows, dst + lane, t);
    const unsigned lines = __ballot_sync(0xffffffffu, any);
    if (lane == 0) w.s.mask[(b * w.chunk + p) * 2 + axis] = lines;
  }
}

// The block's walk over its list of n particles (list(j, pid, code) gives
// entry j): fetch kAhead chunks ahead, stage one ahead, composite(c, m) the
// chunk whose factors are in shared memory; one barrier a chunk.
template <class List, class Composite>
__device__ __forceinline__ void walk(const Walk& w, const float* rec,
                                     const List& list, int n,
                                     const Composite& composite) {
  const int chunks = (n + w.chunk - 1) / w.chunk;
  Fetched first[kAhead];
#pragma unroll
  for (int c = 0; c < kAhead; ++c) first[c] = fetch(w, list, rec, c, n);
#pragma unroll
  for (int c = 0; c < kAhead; ++c) put(w, first[c], c, n);
  __syncthreads();
  if (chunks > 0) stage(w, 0, n);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const Fetched f = fetch(w, list, rec, c + kAhead, n);
    if (c + 1 < chunks) stage(w, c + 1, n);
    composite(c, min(w.chunk, n - c * w.chunk));
    put(w, f, c + kAhead, n);
    __syncthreads();
  }
}

// The coverage of chunk c's particle p at the thread's 4 pixels (rows
// ly0 .. ly0 + 3, column lx), ranks summed in order.
__device__ __forceinline__ void coverage(const Walk& w, int c, int p,
                                         int ly0, int lx, float cov[4]) {
  const int t = w.g.tile;
  const int b = c & 1;
  const float* fy = w.s.fac + ((b * 2 * w.chunk + p) * w.ranks) * t + ly0;
  const float* fx =
      w.s.fac + (((b * 2 + 1) * w.chunk + p) * w.ranks) * t + lx;
  float4 y = *reinterpret_cast<const float4*>(fy);
  float x = fx[0];
  cov[0] = y.x * x;
  cov[1] = y.y * x;
  cov[2] = y.z * x;
  cov[3] = y.w * x;
  for (int r = 1; r < w.ranks; ++r) {
    y = *reinterpret_cast<const float4*>(fy + r * t);
    x = fx[r * t];
    cov[0] = cov[0] + y.x * x;
    cov[1] = cov[1] + y.y * x;
    cov[2] = cov[2] + y.z * x;
    cov[3] = cov[3] + y.w * x;
  }
}

// Chunk c's particle p's masks of the tile's rows (x) and columns (y)
// where a factor is nonzero. Its coverage is exactly 0 on a pixel whose
// row or column bit is 0, so compositing it there changes nothing.
__device__ __forceinline__ uint2 lines(const Walk& w, int c, int p) {
  return *reinterpret_cast<const uint2*>(w.s.mask +
                                         ((c & 1) * w.chunk + p) * 2);
}

// Whether the particle reaches one of the thread's 4 rows (uniform across
// a warp at t = 32) and its column.
__device__ __forceinline__ bool reaches(uint2 m, int ly0, int lx) {
  return ((m.x >> ly0) & 0xFu) && ((m.y >> lx) & 1u);
}

// A list length's class: 0 for an empty list, else 4 classes an octave
// (by the length's top three bits), increasing with the length.
__device__ __forceinline__ int length_class(int count) {
  if (count <= 0) return 0;
  const int lg = 31 - __clz(count);
  const int top = lg >= 2 ? count >> (lg - 2) : count << (2 - lg);
  return 1 + lg * 4 + (top & 3);
}

// The block's tile: the tiles ordered by the class of their list's length,
// longest first, and by index within a class. The blocks start in index
// order, so the longest lists start first and the short ones fill in
// behind them; in screen order the hottest tiles of a frame may start in
// the last wave of blocks and set the kernel's end. Two passes over the
// starts a block, no launch and no host read. Each block scans every
// tile, so the order's cost grows with the square of the tile count:
// above kOrderSpan tiles a thread the blocks take the tiles in screen
// order. Not inlined: its registers are not live across the walk.
__device__ __noinline__ int block_tile(const int* starts, int nt,
                                       int* order) {
  if (nt > kOrderSpan * (int)blockDim.x) return blockIdx.x;
  int* hist = order;               // [kOrderBins] tiles a class
  int* part = order + kOrderBins;  // [32] a warp's tiles of the class
  int* found = part + 32;          // class, rank in it, tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kOrderBins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int i = tid; i < nt; i += blockDim.x)
    atomicAdd(hist + length_class(__ldg(starts + i + 1) - __ldg(starts + i)),
              1);
  __syncthreads();
  if (warp == 0) {
    // Lane l holds classes 127 - 4 l down to 124 - 4 l.
    int h[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = hist[kOrderBins - 1 - (4 * lane + k)];
      sum += h[k];
    }
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int before = incl - sum;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (before <= (int)blockIdx.x && (int)blockIdx.x < before + h[k]) {
        found[0] = kOrderBins - 1 - (4 * lane + k);
        found[1] = blockIdx.x - before;
      }
      before += h[k];
    }
  }
  __syncthreads();
  const int cls = found[0];
  const int rank = found[1];
  // Thread i counts the class's tiles among tiles [i m, i m + m).
  const int m = (nt + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * m, nt);
  const int hi = min(lo + m, nt);
  int mine = 0;
  for (int i = lo; i < hi; ++i)
    mine += length_class(__ldg(starts + i + 1) - __ldg(starts + i)) == cls;
  int incl = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  int before = incl - mine;
  for (int k = 0; k < warp; ++k) before += part[k];
  if (before <= rank && rank < before + mine) {
    int left = rank - before;
    for (int i = lo; i < hi; ++i) {
      if (length_class(__ldg(starts + i + 1) - __ldg(starts + i)) == cls &&
          left-- == 0)
        found[2] = i;
    }
  }
  __syncthreads();
  return found[2];
}

// `ranks` > 0: the kernel's instantiation for that many ranks, which the
// compiler unrolls; 0: any (the table's).
__device__ __forceinline__ Walk begin_walk(Raster g, int kind, Table tab,
                                           int chunk, int table_floats,
                                           const int* starts, int ranks) {
  Walk w;
  w.g = g;
  // Only ranks 1 take a profile: the kind of any other instantiation is
  // known when it compiles.
  w.kind = ranks == 1 ? kind : kSprite;
  w.ranks = ranks > 0 ? ranks : (kind == kSprite ? tab.rank : 1);
  w.chunk = chunk;
  w.tab = tab;
  w.s = carve(table_floats, chunk, w.ranks, g.tile);
  const int tile = block_tile(starts, g.gx * g.gy, w.s.order);
  w.ty = tile / g.gx;
  w.tx = tile - w.ty * g.gx;
  load_table(w, table_floats);
  return w;
}

template <int kRanks, bool kDither>
__global__ void __launch_bounds__(kMaxThreads, 4)
    composite_kernel(const int* __restrict__ ids,
                     const int* __restrict__ starts,
                     const float* __restrict__ rec, Raster g, int kind,
                     Table tab, int chunk, int table_floats,
                     const float* __restrict__ background,
                     float* __restrict__ out) {
  const Walk w =
      begin_walk(g, kind, tab, chunk, table_floats, starts, kRanks);
  const int t = g.tile;
  const bool owner = threadIdx.x < t * t / 4;  // the thread has pixels
  const int lx = threadIdx.x % t;
  const int ly0 = 4 * (threadIdx.x / t);
  // The 4 x 4 Bayer matrix, entry (r, c) in bits 4 (4 r + c) ...
  constexpr unsigned long long kBayer = 0x5d7f91b36e4ca280ull;
  float bayer[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    bayer[i] = (float)((kBayer >> (4 * (i * 4 + (lx & 3)))) & 15u) / 16.0f;
  float cr[4] = {}, cg[4] = {}, cb[4] = {}, ca[4] = {};
  const int tile = w.ty * g.gx + w.tx;
  const int begin = starts[tile];
  const int n = starts[tile + 1] - begin;
  const int* list_ids = ids + begin;
  walk(
      w, rec,
      [&](int j, int& pid, int& code) {
        pid = __ldg(list_ids + j);
        code = kCentre;
      },
      n,
      [&](int c, int m) {
        if (!owner) return;
        const float* rc = w.s.rec + (c % kRecBufs) * w.chunk * kRecord;
        for (int p = 0; p < m; ++p) {
          const uint2 mask = lines(w, c, p);
          if (!reaches(mask, ly0, lx)) continue;
          float cov[4];
          coverage(w, c, p, ly0, lx, cov);
          const float* q = rc + p * kRecord;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = w.kind == kSprite ? clamp01(cov[i]) : cov[i];
            float a = v * q[5];
            if (kDither) a = (a > bayer[i] && a > 0.0f) ? 1.0f : 0.0f;
            const float om = 1.0f - a;
            cr[i] = cr[i] * om + q[2] * a;
            cg[i] = cg[i] * om + q[3] * a;
            cb[i] = cb[i] * om + q[4] * a;
            ca[i] = ca[i] * om + a;
          }
        }
      });
  if (!owner) return;
  const int px = w.tx * t + lx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int py = w.ty * t + ly0 + i;
    if (py >= g.height || px >= g.width) continue;
    const size_t o = ((size_t)py * g.width + px) * 4;
    float r = cr[i], gg = cg[i], bb = cb[i], aa = ca[i];
    if (background != nullptr) {
      // Premultiplied "over" onto the background with the clipped alpha.
      const float a = clamp01(aa);
      const float k = 1.0f - a;
      r = r + __ldg(background + o + 0) * k;
      gg = gg + __ldg(background + o + 1) * k;
      bb = bb + __ldg(background + o + 2) * k;
      aa = a + __ldg(background + o + 3) * k;
    }
    out[o + 0] = r;
    out[o + 1] = gg;
    out[o + 2] = bb;
    out[o + 3] = aa;
  }
}

// Whether a particle at `pos`, binned to tile `src` of this axis, reaches
// line 0 .. t - 1 of tile `own`: its footprint (the support + 1 window
// positions from floor(pos - org + apron - 0.5) - support / 2), clipped to
// its own tile's window and to the image (sprite_accumulate_reference's
// `ok`), meets the tile.
__device__ __forceinline__ bool meets(float pos, int src, int own,
                                      const Raster& g, int support,
                                      int extent) {
  const int t = g.tile;
  const int a = g.apron;
  const float p = ((pos - (float)(src * t)) + (float)a) - 0.5f;
  const int lo = (int)floorf(p) - support / 2;
  const int wlo = max(lo, 0);
  const int whi = min(lo + support, t + 2 * a - 1);
  const int w0 = a + (own - src) * t;  // the window position of line 0
  const int llo = max(wlo - w0, 0);
  const int lhi = min(min(whi - w0, t - 1), extent - 1 - own * t);
  return llo <= lhi;
}

// K11b's pre-filter: of each neighbour row r (dy = r - 1; the lists of
// tiles sx0[r] .. sx0[r] + 2 at most, one contiguous range of ids), the
// entries that meet this tile, in list order, as (pid << kCodeBits) | code
// into keep[at[r] + 0 .. kept[r]].
__device__ __forceinline__ void filter(const Walk& w, const int* ids,
                                       const int* starts, const float* rec,
                                       int* keep, int entries, int at[3],
                                       int kept[3]) {
  const Raster& g = w.g;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  int begin[3], end[3], sx0[3], bound[3][2];
  int longest = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int sy = w.ty + r - 1;
    sx0[r] = max(w.tx - 1, 0);
    const int sx1 = min(w.tx + 1, g.gx - 1);
    begin[r] = end[r] = 0;
    bound[r][0] = bound[r][1] = 0;
    if (sy >= 0 && sy < g.gy) {
      const int row = sy * g.gx;
      begin[r] = starts[row + sx0[r]];
      end[r] = starts[row + sx1 + 1];
      // Ends of the range's first two tiles: an entry's tile is sx0 plus
      // the number of these it lies past.
      bound[r][0] = starts[row + min(sx0[r] + 1, sx1 + 1)];
      bound[r][1] = starts[row + min(sx0[r] + 2, sx1 + 1)];
    }
    at[r] = (r * 3 + w.tx % 3) * entries + begin[r];
    kept[r] = 0;
    longest = max(longest, end[r] - begin[r]);
  }
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0, parity = 0; base < longest;
       base += blockDim.x, parity ^= 1) {
    int pid[3], code[3];
    bool hit[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int i = begin[r] + base + threadIdx.x;
      hit[r] = i < end[r];
      pid[r] = hit[r] ? __ldg(ids + i) : 0;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int i = begin[r] + base + threadIdx.x;
      code[r] = 0;
      if (hit[r]) {
        const float x = __ldg(rec + (size_t)pid[r] * kRecord + 0);
        const float y = __ldg(rec + (size_t)pid[r] * kRecord + 1);
        const int sx = sx0[r] + (i >= bound[r][0]) + (i >= bound[r][1]);
        const int sy = w.ty + r - 1;
        hit[r] = meets(y, sy, w.ty, g, w.tab.support, g.height) &&
                 meets(x, sx, w.tx, g, w.tab.support, g.width);
        code[r] = r * 3 + (sx - w.tx + 1);
      }
    }
    unsigned ballot[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ballot[r] = __ballot_sync(0xffffffffu, hit[r]);
      if (lane == 0)
        w.s.counts[(parity * 3 + r) * warps + warp] = __popc(ballot[r]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      int before = 0, total = 0;
      for (int k = 0; k < warps; ++k) {
        const int n = w.s.counts[(parity * 3 + r) * warps + k];
        total += n;
        before += k < warp ? n : 0;
      }
      if (hit[r])
        keep[at[r] + kept[r] + before + __popc(ballot[r] & below)] =
            (pid[r] << kCodeBits) | code[r];
      kept[r] += total;
    }
  }
  __syncthreads();  // the kept entries are visible to the whole block
}

template <int kRanks>
__global__ void __launch_bounds__(kMaxThreads, 4)
    accumulate_kernel(const int* __restrict__ ids,
                      const int* __restrict__ starts,
                      const float* __restrict__ rec, Raster g, Table tab,
                      int chunk, int table_floats, int channels, int* keep,
                      int entries, float* __restrict__ out) {
  const Walk w =
      begin_walk(g, kSprite, tab, chunk, table_floats, starts, kRanks);
  const int t = g.tile;
  const bool owner = threadIdx.x < t * t / 4;
  const int lx = threadIdx.x % t;
  const int ly0 = 4 * (threadIdx.x / t);
  int at[3], kept[3];
  filter(w, ids, starts, rec, keep, entries, at, kept);
  // Where rows 1 and 2 begin in the walk's list.
  const int k1 = kept[0];
  const int k2 = kept[0] + kept[1];
  float acc[4][4] = {};
  walk(
      w, rec,
      [&](int j, int& pid, int& code) {
        // Written by this block in `filter`: a coherent load.
        const int i = j < k1 ? at[0] + j
                             : (j < k2 ? at[1] + j - k1 : at[2] + j - k2);
        const int v = keep[i];
        pid = v >> kCodeBits;
        code = v & ((1 << kCodeBits) - 1);
      },
      k2 + kept[2],
      [&](int c, int m) {
        if (!owner) return;
        const float* rc = w.s.rec + (c % kRecBufs) * w.chunk * kRecord;
        for (int p = 0; p < m; ++p) {
          const uint2 mask = lines(w, c, p);
          if (!reaches(mask, ly0, lx)) continue;
          float cov[4];
          coverage(w, c, p, ly0, lx, cov);
          const float* q = rc + p * kRecord;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (k < channels) acc[i][k] = acc[i][k] + cov[i] * q[2 + k];
            }
          }
        }
      });
  if (!owner) return;
  const int px = w.tx * t + lx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int py = w.ty * t + ly0 + i;
    if (py >= g.height || px >= g.width) continue;
    const size_t o = ((size_t)py * g.width + px) * channels;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < channels) out[o + k] = acc[i][k];
    }
  }
}

Raster raster(int height, int width, int tile, int apron) {
  Raster g;
  g.height = height;
  g.width = width;
  g.tile = tile;
  g.apron = apron;
  g.gy = (height + tile - 1) / tile;
  g.gx = (width + tile - 1) / tile;
  return g;
}

// A launch's block: threads, chunk, the table's floats in shared memory
// (0: read from global memory) and the dynamic shared memory.
struct Plan {
  int threads, chunk, table_floats;
  size_t smem;
};

Plan plan(int tile, int ranks, int table_floats) {
  Plan p;
  p.threads = ((tile * tile / 4 + 31) / 32) * 32;
  int chunk = kStageFloats / (2 * ranks * tile);
  chunk = chunk < kMaxChunk ? chunk : kMaxChunk;
  chunk = chunk < p.threads ? chunk : p.threads;
  p.chunk = chunk < 1 ? 1 : chunk;
  p.table_floats =
      (size_t)table_floats * sizeof(float) <= (size_t)kTableSmemBytes
          ? table_floats
          : 0;
  p.smem = sizeof(float) *
           smem_words(p.table_floats, p.chunk, ranks, tile, p.threads / 32);
  return p;
}

// Lets `kernel` take the card's largest dynamic shared memory and prefer
// shared memory over L1, once a device (outside any graph capture: the
// wrappers' first call precedes it).
template <class Kernel>
cudaError_t opt_in(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  done[dev] = true;
  return cudaSuccess;
}

// The kernels' instantiations: ranks 1 (every profile), 4 (the leaf
// tables of the sprite cells) and any other.
constexpr int kVariants = 3;
int variant(int ranks) { return ranks == 1 ? 0 : (ranks == 4 ? 1 : 2); }

using CompositeFn = void (*)(const int*, const int*, const float*, Raster,
                             int, Table, int, int, const float*, float*);
using AccumulateFn = void (*)(const int*, const int*, const float*, Raster,
                              Table, int, int, int, int*, int, float*);
// [rank variant][dither]
const CompositeFn kComposite[kVariants][2] = {
    {composite_kernel<1, false>, composite_kernel<1, true>},
    {composite_kernel<4, false>, composite_kernel<4, true>},
    {composite_kernel<0, false>, composite_kernel<0, true>}};
const AccumulateFn kAccumulate[kVariants] = {
    accumulate_kernel<1>, accumulate_kernel<4>, accumulate_kernel<0>};
bool composite_ready[kVariants][2][64];
bool accumulate_ready[kVariants][64];

bool valid(int tile, int apron, int ranks) {
  return tile >= 4 && tile <= kMaxTile && tile % 4 == 0 && apron >= 0 &&
         apron <= tile && ranks >= 1 && ranks <= kMaxRank;
}

}  // namespace

// kind: 0 quad, 1 gauss, 2 round (analytic profiles), 3 sprite (rows,
// cols (variants, rank, support) float32). background: (H, W, 4) or null.
extern "C" int tile_composite(const void* ids, const void* starts,
                              const void* records, const void* rows,
                              const void* cols, int variants, int rank,
                              int support, const void* background, void* out,
                              int height, int width, int tile, int apron,
                              int kind, int dither, void* stream) {
  const int ranks = kind == kSprite ? rank : 1;
  if (kind < kQuad || kind > kSprite || !valid(tile, apron, ranks) ||
      (kind == kSprite && (variants < 1 || support < 1)))
    return (int)cudaErrorInvalidValue;
  const Raster g = raster(height, width, tile, apron);
  Table tab;
  tab.rows = (const float*)rows;
  tab.cols = (const float*)cols;
  tab.variants = variants;
  tab.rank = rank;
  tab.support = support;
  const Plan p =
      plan(tile, ranks, kind == kSprite ? 2 * variants * rank * support : 0);
  const int v = variant(ranks);
  const int d = dither ? 1 : 0;
  const cudaError_t err = opt_in(kComposite[v][d], composite_ready[v][d]);
  if (err != cudaSuccess) return (int)err;
  kComposite[v][d]<<<g.gx * g.gy, p.threads, p.smem, (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)starts, (const float*)records, g, kind, tab,
      p.chunk, p.table_floats, (const float*)background, (float*)out);
  return (int)cudaGetLastError();
}

// rows, cols (variants, rank, support) float32; out (H, W, channels);
// keep: int32 scratch of 9 x `entries` (the length of ids), below 2^27
// as the particle indices are.
extern "C" int tile_accumulate(const void* ids, const void* starts,
                               const void* records, const void* rows,
                               const void* cols, int variants, int rank,
                               int support, void* keep, long long entries,
                               void* out, int height, int width, int tile,
                               int apron, int channels, void* stream) {
  if (!valid(tile, apron, rank) || variants < 1 || support < 1 ||
      channels < 1 || channels > 4 || entries < 0 ||
      entries >= (1ll << (31 - kCodeBits)))
    return (int)cudaErrorInvalidValue;
  const Raster g = raster(height, width, tile, apron);
  Table tab;
  tab.rows = (const float*)rows;
  tab.cols = (const float*)cols;
  tab.variants = variants;
  tab.rank = rank;
  tab.support = support;
  const Plan p = plan(tile, rank, 2 * variants * rank * support);
  const int v = variant(rank);
  const cudaError_t err = opt_in(kAccumulate[v], accumulate_ready[v]);
  if (err != cudaSuccess) return (int)err;
  kAccumulate[v]<<<g.gx * g.gy, p.threads, p.smem, (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)starts, (const float*)records, g, tab,
      p.chunk, p.table_floats, channels, (int*)keep, (int)entries,
      (float*)out);
  return (int)cudaGetLastError();
}

// The launch a call makes at these sizes, after the wrappers' opt-in:
// out[0..6] = threads, chunk, table floats in shared memory (0: read from
// global memory), dynamic shared memory bytes, resident blocks an SM,
// registers a thread, local memory bytes a thread (spills).
extern "C" int tile_plan(int accumulate, int tile, int ranks,
                         int table_floats, int* out) {
  if (!valid(tile, 0, ranks) || table_floats < 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(tile, ranks, table_floats);
  const int v = variant(ranks);
  const void* kernel = accumulate ? (const void*)kAccumulate[v]
                                  : (const void*)kComposite[v][0];
  cudaError_t err = accumulate
                        ? opt_in(kAccumulate[v], accumulate_ready[v])
                        : opt_in(kComposite[v][0], composite_ready[v][0]);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      p.threads, p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.threads;
  out[1] = p.chunk;
  out[2] = p.table_floats;
  out[3] = (int)p.smem;
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  return 0;
}
