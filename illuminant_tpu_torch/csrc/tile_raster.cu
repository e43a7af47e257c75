// Tile compositor and additive sprite splat for Hopper (sm_90a).
//
// Replaces the XLA stages of illuminant_tpu/raster/tiled.py:
// composite_over_tiles (a lax.scan over bin slots: every slot step updates
// every tile's (win, win, 4) image from one-hot coverage factors) and the
// additive splat of illuminant_tpu/raster/sprites.py:rasterize_sprites
// (rank-R one-hot matmuls per tile, then an overlap-add of the tile
// windows). Two kernels on shared device functions:
//   * tile_composite (K11a): the ordered "over" of a tile's binned
//     particles in draw order, with an analytic profile (quad, gauss,
//     round: tiled._profile) or a sprite table's rank-R factors, the Bayer
//     dither, the opacity folded into each record's alpha, and the
//     background "over" fused in as the epilogue;
//   * tile_accumulate (K11b): the additive sprite coverage: each pixel sums
//     the particles binned to its own tile and to its 8 neighbours whose
//     windows (the tile plus `apron`) cover it.
//
// Layout: one block per 32 x 32 screen tile, one thread per pixel. The
// block walks its tile's list (ids[starts[t]:starts[t + 1]], particle
// indices in draw order, from raster/tiled.py:bin_footprints) in chunks:
// first the block computes each chunk particle's separable factors, one
// value per rank for each of the tile's 32 rows and 32 columns, into
// shared memory (with a bit mask of the rows where any factor is nonzero);
// then each thread runs the chunk in order on its pixel, from registers,
// skipping a particle whose factors vanish on its row (a warp is one row,
// so the skip does not diverge).
//
// What bounds it on an H100: the ordered loop of the hottest tile. The
// work is a few tens of float operations per (particle, pixel) pair of a
// tile's list, ~10^8-10^9 at the 1080p cell, and the bytes are small (the
// records, the lists, the image once); a tile's list runs in order on one
// SM, so the most crowded tile sets the time more than the card's rates
// do. The separable factors keep the per-pair work to R products and the
// over; the row skip drops the pairs outside a particle's footprint rows.
//
// Rounding: the file is compiled with -fmad=false and follows the plain
// versions' operation order (raster/tile_kernel.py:
// composite_over_tiles_reference, sprite_accumulate_reference), so the
// composite equals its plain version bit for bit (division is IEEE on both
// sides; a skipped pair adds exactly nothing). The additive splat sums a
// pixel's particles in another order than the plain version's scatter, so
// it agrees to float32 reordering, not bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 32;
// Factor floats a chunk may hold in shared memory (32 KB): the chunk is
// kFactorFloats / (2 * ranks * tile) particles, fewer where the chunk's
// whole shared memory would pass kSmemLimit.
constexpr int kFactorFloats = 8192;
// The dynamic shared memory a block may take without an opt-in.
constexpr size_t kSmemLimit = 48 * 1024;
constexpr int kMaxRank = 64;
constexpr int kRecord = 8;  // x, y, c0, c1, c2, c3, radius, variant

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
// the window of the tile the particle is binned to (origin `org`): one
// value a rank into dst[0], dst[stride], ...; 0 outside the window.
// Returns whether any is nonzero.
__device__ __forceinline__ bool factors(int kind, const Table& tab,
                                        const float* q, float pos, float org,
                                        int apron, int w, int win,
                                        const float* table_axis, float* dst,
                                        int stride) {
  const int ranks = kind == kSprite ? tab.rank : 1;
  if (w < 0 || w >= win) {
    for (int r = 0; r < ranks; ++r) dst[r * stride] = 0.0f;
    return false;
  }
  if (kind != kSprite) {
    // tiled._coverage_factors: window-local centre (pos - org) + apron,
    // sample at w + 0.5.
    const float d = ((float)w + 0.5f) - ((pos - org) + (float)apron);
    const float v = profile(kind, d, q[6]);
    dst[0] = v;
    return v != 0.0f;
  }
  // sprites._sprite_bins_and_factors: p = (pos - org) + apron - 0.5, the
  // factor at tap s lerped with the fraction of p.
  const float p = ((pos - org) + (float)apron) - 0.5f;
  const float fl = floorf(p);
  const float f = p - fl;
  const int half = tab.support / 2;
  const int dd = w - (int)fl;
  const int s1 = dd - 1 + half;
  const int s2 = dd + half;
  const bool ok1 = s1 >= 0 && s1 < tab.support;
  const bool ok2 = s2 >= 0 && s2 < tab.support;
  int b = (int)q[7];
  b = min(max(b, 0), tab.variants - 1);
  const float* fr = table_axis + (size_t)b * ranks * tab.support;
  bool any = false;
  for (int r = 0; r < ranks; ++r) {
    const float c1 = ok1 ? f * __ldg(fr + r * tab.support + s1) : 0.0f;
    const float c2 = ok2 ? (1.0f - f) * __ldg(fr + r * tab.support + s2)
                         : 0.0f;
    const float v = c1 + c2;
    dst[r * stride] = v;
    any |= v != 0.0f;
  }
  return any;
}

// Shared memory of a chunk of `chunk` particles at `ranks` ranks.
struct Smem {
  float* fy;  // [chunk][ranks][tile] row factors
  float* fx;  // [chunk][ranks][tile] column factors
  float* val;  // [chunk][4] the record's four colour values
  unsigned int* rows;  // [chunk] rows with a nonzero factor
};

__device__ __forceinline__ Smem carve(int chunk, int ranks, int tile) {
  extern __shared__ float smem[];
  Smem s;
  s.fy = smem;
  s.fx = s.fy + chunk * ranks * tile;
  s.val = s.fx + chunk * ranks * tile;
  s.rows = reinterpret_cast<unsigned int*>(s.val + chunk * 4);
  return s;
}

// Phase 1: the factors of particles ids[base:base + n] on the block's
// tile, whose rows sit at window rows wy0 + l and columns at wx0 + l of
// the windows of the tile the list belongs to (origin oy, ox).
__device__ __forceinline__ void stage(const Smem& s, const int* ids, int base,
                                      int n, const float* rec, int kind,
                                      const Table& tab, int ranks,
                                      const Raster& g, float oy, float ox,
                                      int wy0, int wx0) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int t = g.tile;
  const int win = t + 2 * g.apron;
  for (int i = tid; i < n; i += nthreads) {
    const float* q = rec + (size_t)__ldg(ids + base + i) * kRecord;
    s.rows[i] = 0u;
    for (int c = 0; c < 4; ++c) s.val[i * 4 + c] = __ldg(q + 2 + c);
  }
  __syncthreads();
  for (int it = tid; it < n * 2 * t; it += nthreads) {
    const int p = it / (2 * t);
    const int rem = it - p * 2 * t;
    const int axis = rem / t;  // 0: rows, 1: columns
    const int l = rem - axis * t;
    const float* q = rec + (size_t)__ldg(ids + base + p) * kRecord;
    if (axis == 0) {
      const bool any = factors(kind, tab, q, __ldg(q + 1), oy, g.apron,
                               wy0 + l, win, tab.rows,
                               s.fy + (p * ranks) * t + l, t);
      if (any) atomicOr(s.rows + p, 1u << l);
    } else {
      factors(kind, tab, q, __ldg(q + 0), ox, g.apron, wx0 + l, win,
              tab.cols, s.fx + (p * ranks) * t + l, t);
    }
  }
  __syncthreads();
}

// The coverage of chunk particle p at the thread's pixel (ly, lx).
__device__ __forceinline__ float coverage(const Smem& s, int p, int ranks,
                                          int t, int ly, int lx) {
  const float* fy = s.fy + (p * ranks) * t;
  const float* fx = s.fx + (p * ranks) * t;
  float cov = fy[ly] * fx[lx];
  for (int r = 1; r < ranks; ++r) cov = cov + fy[r * t + ly] * fx[r * t + lx];
  return cov;
}

__global__ void __launch_bounds__(1024)
    composite_kernel(const int* __restrict__ ids,
                     const int* __restrict__ starts,
                     const float* __restrict__ rec, Raster g, int kind,
                     Table tab, int chunk, int dither,
                     const float* __restrict__ background,
                     float* __restrict__ out) {
  const int ranks = kind == kSprite ? tab.rank : 1;
  const Smem s = carve(chunk, ranks, g.tile);
  const int t = g.tile;
  const int tile = blockIdx.x;
  const int ty = tile / g.gx;
  const int tx = tile - ty * g.gx;
  const int ly = threadIdx.x / t;
  const int lx = threadIdx.x - ly * t;
  const float oy = (float)(ty * t);
  const float ox = (float)(tx * t);
  const int bayer_i[16] = {0, 8, 2, 10, 12, 4, 14, 6,
                           3, 11, 1, 9, 15, 7, 13, 5};
  const float bayer = (float)bayer_i[(ly & 3) * 4 + (lx & 3)] / 16.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, ca = 0.0f;
  const int begin = starts[tile];
  const int end = starts[tile + 1];
  for (int base = begin; base < end; base += chunk) {
    const int n = min(chunk, end - base);
    stage(s, ids, base, n, rec, kind, tab, ranks, g, oy, ox, g.apron,
          g.apron);
    for (int p = 0; p < n; ++p) {
      if (!((s.rows[p] >> ly) & 1u)) continue;
      float cov = coverage(s, p, ranks, t, ly, lx);
      if (kind == kSprite) cov = clamp01(cov);
      float a = cov * s.val[p * 4 + 3];
      if (dither) a = (a > bayer && a > 0.0f) ? 1.0f : 0.0f;
      const float om = 1.0f - a;
      cr = cr * om + s.val[p * 4 + 0] * a;
      cg = cg * om + s.val[p * 4 + 1] * a;
      cb = cb * om + s.val[p * 4 + 2] * a;
      ca = ca * om + a;
    }
    __syncthreads();
  }
  const int py = ty * t + ly;
  const int px = tx * t + lx;
  if (py >= g.height || px >= g.width) return;
  const size_t o = ((size_t)py * g.width + px) * 4;
  if (background != nullptr) {
    // Premultiplied "over" onto the background with the clipped alpha.
    const float a = clamp01(ca);
    const float k = 1.0f - a;
    cr = cr + __ldg(background + o + 0) * k;
    cg = cg + __ldg(background + o + 1) * k;
    cb = cb + __ldg(background + o + 2) * k;
    ca = a + __ldg(background + o + 3) * k;
  }
  out[o + 0] = cr;
  out[o + 1] = cg;
  out[o + 2] = cb;
  out[o + 3] = ca;
}

__global__ void __launch_bounds__(1024)
    accumulate_kernel(const int* __restrict__ ids,
                      const int* __restrict__ starts,
                      const float* __restrict__ rec, Raster g, Table tab,
                      int chunk, int channels, float* __restrict__ out) {
  const int ranks = tab.rank;
  const Smem s = carve(chunk, ranks, g.tile);
  const int t = g.tile;
  const int tile = blockIdx.x;
  const int ty = tile / g.gx;
  const int tx = tile - ty * g.gx;
  const int ly = threadIdx.x / t;
  const int lx = threadIdx.x - ly * t;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int dy = -1; dy <= 1; ++dy) {
    const int sy = ty + dy;
    if (sy < 0 || sy >= g.gy) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int sx = tx + dx;
      if (sx < 0 || sx >= g.gx) continue;
      const int src = sy * g.gx + sx;
      const int begin = starts[src];
      const int end = starts[src + 1];
      // This tile's row l is row (ty - sy) * t + apron + l of the source
      // tile's window.
      const int wy0 = (ty - sy) * t + g.apron;
      const int wx0 = (tx - sx) * t + g.apron;
      for (int base = begin; base < end; base += chunk) {
        const int n = min(chunk, end - base);
        stage(s, ids, base, n, rec, kSprite, tab, ranks, g,
              (float)(sy * t), (float)(sx * t), wy0, wx0);
        for (int p = 0; p < n; ++p) {
          if (!((s.rows[p] >> ly) & 1u)) continue;
          const float cov = coverage(s, p, ranks, t, ly, lx);
          for (int c = 0; c < 4; ++c) {
            if (c < channels) acc[c] = acc[c] + cov * s.val[p * 4 + c];
          }
        }
        __syncthreads();
      }
    }
  }
  const int py = ty * t + ly;
  const int px = tx * t + lx;
  if (py >= g.height || px >= g.width) return;
  const size_t o = ((size_t)py * g.width + px) * channels;
  for (int c = 0; c < 4; ++c) {
    if (c < channels) out[o + c] = acc[c];
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

size_t smem_bytes(int chunk, int ranks, int tile) {
  return sizeof(float) * ((size_t)2 * chunk * ranks * tile + 4 * chunk) +
         sizeof(unsigned int) * chunk;
}

int chunk_for(int ranks, int tile) {
  const int c = kFactorFloats / (2 * ranks * tile);
  const int fit = (int)(kSmemLimit / smem_bytes(1, ranks, tile));
  const int chunk = c < fit ? c : fit;
  return chunk < 1 ? 1 : chunk;
}

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
  const int chunk = chunk_for(ranks, tile);
  composite_kernel<<<g.gx * g.gy, tile * tile, smem_bytes(chunk, ranks, tile),
                     (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)starts, (const float*)records, g, kind, tab,
      chunk, dither, (const float*)background, (float*)out);
  return (int)cudaGetLastError();
}

// rows, cols (variants, rank, support) float32; out (H, W, channels).
extern "C" int tile_accumulate(const void* ids, const void* starts,
                               const void* records, const void* rows,
                               const void* cols, int variants, int rank,
                               int support, void* out, int height, int width,
                               int tile, int apron, int channels,
                               void* stream) {
  if (!valid(tile, apron, rank) || variants < 1 || support < 1 ||
      channels < 1 || channels > 4)
    return (int)cudaErrorInvalidValue;
  const Raster g = raster(height, width, tile, apron);
  Table tab;
  tab.rows = (const float*)rows;
  tab.cols = (const float*)cols;
  tab.variants = variants;
  tab.rank = rank;
  tab.support = support;
  const int chunk = chunk_for(rank, tile);
  accumulate_kernel<<<g.gx * g.gy, tile * tile,
                      smem_bytes(chunk, rank, tile), (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)starts, (const float*)records, g, tab,
      chunk, channels, (float*)out);
  return (int)cudaGetLastError();
}
