// The port's distance fields as device functions: the exact trilinear
// sample of an SdfVolume, the closed-form AnalyticScene (the five
// obstruction primitives with their quaternion rotation, and the extruded
// polygons of its height volumes), and the ColumnField reconstruction,
// which is column_query.cuh's `column_distance` (shared with K7 and K10).
// The cone-trace march (cone_trace.cu, K12) samples them once a step; the
// scan readout (scan_readout.cu, K2) at each refine candidate; the
// collision integrate (collide_integrate.cu, K4) once a substep, and takes
// the scene's closed-form collision normal (`analytic_normal_fast`; the
// normals that are not closed forms are sdf_gradients.cuh's).
//
// Each function keeps the operation order of its plain PyTorch version:
// sdf/sampling.py:sample, ops/sdf_primitives.py's planar forms (`*_p`)
// through sdf/analytic.py:AnalyticScene.distance_p (or, above its unroll
// limit, `_distance_vectorized`'s batched forms), and sdf/height_volume.py:
// extruded_polygon_distance_p, and the normals sdf/analytic.py:
// AnalyticScene.normal_fast_p's. Every file that includes this header is
// compiled with -fmad=false, so products and sums round one by one as in
// PyTorch; sqrtf and the division are IEEE.

#pragma once

#include <cuda_runtime.h>

#include "column_query.cuh"

namespace illum_fields {

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// torch.sign: -1, 0 or 1.
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// ---------------------------------------------------------------- volume

// An SdfVolume: (S, H, W) float32 raw distances, read as each texel's
// 2 x 2 xy taps packed into one float4 with the edge clamp baked in
// (cone_trace.cu:pack_volume_kernel), and the constants of
// sdf/sampling.py:sample, float32 as PyTorch rounds its Python scalars.
// Offsets are 32-bit: the wrapper refuses a volume of 2^31 elements.
struct Volume {
  const float4* pack;        // (S, H, W)
  const float* max_valid_z;  // the volume's 0-d tensor, on the device
  float ex, ey, ez, z_offset, z_to_slice, scale_x, scale_y;
  int slices, height, width;
};

__device__ __forceinline__ int clip_index(float fl, int n) {
  // torch's .long() of a floor, then clamp(0, n - 1).
  const int i = __float2int_rz(fl);
  return min(max(i, 0), n - 1);
}

// sampling.sample: clamp into the box, bilinear xy on two slices, linear
// z, plus the distance from the query to the box. `max_valid_z` is the
// volume's, read once by the caller. A slice's four taps are one 16-byte
// record of the pack.
__device__ __forceinline__ float volume_distance(const Volume& v,
                                                 float max_valid_z, float px,
                                                 float py, float pz_in) {
  const float pz = pz_in - v.z_offset;
  const float cx = fminf(fmaxf(px, 0.0f), v.ex);
  const float cy = fminf(fmaxf(py, 0.0f), v.ey);
  const float cz = fminf(fmaxf(pz, 0.0f), v.ez);
  const float dx = -fminf(px, 0.0f) + fmaxf(px - v.ex, 0.0f);
  const float dy = -fminf(py, 0.0f) + fmaxf(py - v.ey, 0.0f);
  const float dz = -fminf(pz, 0.0f) + fmaxf(pz - v.ez, 0.0f);
  // Inside the box dx = dy = dz = +0 and the root is +0: skipped there.
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float to_volume = d2 == 0.0f ? 0.0f : sqrtf(d2);

  const float slice_pos = fminf(cz, max_valid_z) * v.z_to_slice;
  const float s0 = floorf(slice_pos);
  const float sw = slice_pos - s0;
  const int s0i = clip_index(s0, v.slices);
  const int s1i = min(s0i + 1, v.slices - 1);

  const float tx = cx * v.scale_x - 0.5f;
  const float ty = cy * v.scale_y - 0.5f;
  const float x0 = floorf(tx);
  const float y0 = floorf(ty);
  const float wx = tx - x0;
  const float wy = ty - y0;
  const int x0i = clip_index(x0, v.width);
  const int y0i = clip_index(y0, v.height);

  const int plane = v.height * v.width;
  const int t = y0i * v.width + x0i;
  float slab[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float4 q = __ldg(v.pack + (k == 0 ? s0i : s1i) * plane + t);
    const float top = q.x + (q.y - q.x) * wx;
    const float bot = q.z + (q.w - q.z) * wx;
    slab[k] = top + (bot - top) * wy;
  }
  return slab[0] + (slab[1] - slab[0]) * sw + to_volume;
}

// -------------------------------------------------------------- analytic

enum PrimitiveType {
  kEllipsoid = 1,
  kBox = 2,
  kCylinder = 3,
  kSpheroid = 4,
  kOctagon = 5
};

// One primitive record of 12 floats (analytic.py's type-grouped SoA,
// flattened by the wrapper): type, rotated (0 / 1), center xyz, size
// xyz, quaternion xyzw.
constexpr int kPrimitiveRecord = 12;

// Height volumes (sdf/height_volume.py:HeightVolumes): vertices and
// next_vertices (P, E, 2), z_range (P, 2), active (P,).
struct Polygons {
  const float* vertices;
  const float* next_vertices;
  const float* z_range;
  const float* active;
  int count, edges;
};

// A load from the scene's arrays: kShared, a copy the block made in
// shared memory; else device memory through the read-only cache.
template <bool kShared>
__device__ __forceinline__ float ld(const float* p) {
  if (kShared) return *p;
  return __ldg(p);
}

template <bool kShared>
__device__ __forceinline__ float4 ld4(const float* p) {
  if (kShared) return *reinterpret_cast<const float4*>(p);
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <bool kShared>
__device__ __forceinline__ float2 ld2(const float* p) {
  if (kShared) return *reinterpret_cast<const float2*>(p);
  return __ldg(reinterpret_cast<const float2*>(p));
}

struct Analytic {
  const float* records;  // (n, kPrimitiveRecord), 16-byte aligned
  int count;
  // 1: `_distance_vectorized`'s batched forms (more primitives than the
  // unroll limit); they differ from the planar ones in the octagon only.
  int batched;
  float maximum_distance;
  Polygons polygons;  // count 0: none
};

__device__ __forceinline__ float len3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z + 1e-12f);
}

__device__ __forceinline__ float len2(float x, float y) {
  return sqrtf(x * x + y * y + 1e-12f);
}

__device__ __forceinline__ float sd_box(float px, float py, float pz,
                                        float sx, float sy, float sz) {
  const float dx = fabsf(px) - sx;
  const float dy = fabsf(py) - sy;
  const float dz = fabsf(pz) - sz;
  const float inside = fminf(fmaxf(dx, fmaxf(dy, dz)), 0.0f);
  const float outside = len3(fmaxf(dx, 0.0f), fmaxf(dy, 0.0f),
                             fmaxf(dz, 0.0f));
  return inside + outside;
}

__device__ __forceinline__ float sd_ellipsoid(float px, float py, float pz,
                                              float sx, float sy, float sz) {
  sx = fmaxf(sx, 1e-6f);
  sy = fmaxf(sy, 1e-6f);
  sz = fmaxf(sz, 1e-6f);
  const float k0 = len3(px / sx, py / sy, pz / sz);
  const float k1 = len3(px / (sx * sx), py / (sy * sy), pz / (sz * sz));
  const float rmin = fminf(sx, fminf(sy, sz));
  const float near_ = (k0 - 1.0f) * rmin;
  const float far_ = k0 * (k0 - 1.0f) / fmaxf(k1, 1e-12f);
  return k0 < 1.0f ? near_ : far_;
}

// opElongate: q and the interior term w.
__device__ __forceinline__ float elongate(float px, float py, float pz,
                                          float hx, float hy, float hz,
                                          float* qx, float* qy, float* qz) {
  const float ax = fabsf(px) - hx;
  const float ay = fabsf(py) - hy;
  const float az = fabsf(pz) - hz;
  const float w = fminf(fmaxf(ax, fmaxf(ay, az)), 0.0f);
  *qx = sgn(px) * fmaxf(ax, 0.0f);
  *qy = sgn(py) * fmaxf(ay, 0.0f);
  *qz = sgn(pz) * fmaxf(az, 0.0f);
  return w;
}

__device__ __forceinline__ float sd_spheroid(float px, float py, float pz,
                                             float sx, float sy, float sz) {
  const float ms = fminf(sx, fminf(sy, sz));
  float qx, qy, qz;
  const float w = elongate(px, py, pz, sx - ms, sy - ms, sz - ms, &qx, &qy,
                           &qz);
  return w + (len3(qx, qy, qz) - ms);
}

__device__ __forceinline__ float sd_cylinder(float px, float py, float pz,
                                             float sx, float sy, float sz) {
  const float r = len2(sx, sy);
  const float d_xy = len2(px, py) - r;
  const float d_z = fabsf(pz) - sz;
  const float inside = fminf(fmaxf(d_xy, d_z), 0.0f);
  const float outside = len2(fmaxf(d_xy, 0.0f), fmaxf(d_z, 0.0f));
  return inside + outside;
}

// The octagon prism elongated over xy. The planar form (sd_octagon_p)
// takes the 2D root with +1e-12 and sums (w + inside) + outside; the
// batched one (sd_octagon) has no +1e-12 there and sums
// w + (inside + outside).
__device__ __forceinline__ float sd_octagon(float px, float py, float pz,
                                            float sx, float sy, float sz,
                                            bool batched) {
  const float ms = fminf(sx, sy);
  float qx, qy, qz;
  const float w = elongate(px, py, pz, sx - ms, sy - ms, 0.0f, &qx, &qy,
                           &qz);
  const float kx = -0.9238795325f;
  const float ky = 0.3826834323f;
  const float kz = 0.4142135623f;
  float ax = fabsf(qx);
  float ay = fabsf(qy);
  const float az = fabsf(qz);
  const float m1 = 2.0f * fminf(kx * ax + ky * ay, 0.0f);
  ax = ax - m1 * kx;
  ay = ay - m1 * ky;
  const float m2 = 2.0f * fminf(-kx * ax + ky * ay, 0.0f);
  ax = ax - m2 * -kx;
  ay = ay - m2 * ky;
  ax = ax - fminf(fmaxf(ax, -kz * ms), kz * ms);
  ay = ay - ms;
  const float root = batched ? sqrtf(ax * ax + ay * ay)
                             : sqrtf(ax * ax + ay * ay + 1e-12f);
  const float dxo = root * sgn(ay);
  const float dzo = az - sz;
  const float inside = fminf(fmaxf(dxo, dzo), 0.0f);
  const float outside = len2(fmaxf(dxo, 0.0f), fmaxf(dzo, 0.0f));
  return batched ? w + (inside + outside) : w + inside + outside;
}

// rotateLocalPosition (rotate_by_quaternion_p).
__device__ __forceinline__ void rotate(float* px, float* py, float* pz,
                                       float qx, float qy, float qz,
                                       float qw) {
  const float x = *px, y = *py, z = *pz;
  const float tx = 2.0f * (qy * z - qz * y);
  const float ty = 2.0f * (qz * x - qx * z);
  const float tz = 2.0f * (qx * y - qy * x);
  *px = x + qw * tx + (qy * tz - qz * ty);
  *py = y + qw * ty + (qz * tx - qx * tz);
  *pz = z + qw * tz + (qx * ty - qy * tx);
}

// iq's signed polygon distance (polygon_sdf_2d_p) of polygon p.
template <bool kShared>
__device__ __forceinline__ float polygon_sdf(const Polygons& g, int p,
                                             float px, float py) {
  const float* a = g.vertices + p * g.edges * 2;
  const float* b = g.next_vertices + p * g.edges * 2;
  float dist2 = 0.0f;
  int flips = 0;
  for (int e = 0; e < g.edges; ++e) {
    const float2 va = ld2<kShared>(a + 2 * e);
    const float2 vb = ld2<kShared>(b + 2 * e);
    const float ax = va.x, ay = va.y, bx = vb.x, by = vb.y;
    const float ex = bx - ax, ey = by - ay;
    const float wx = px - ax, wy = py - ay;
    const float ee = fmaxf(ex * ex + ey * ey, 1e-12f);
    const float t = clamp01((wx * ex + wy * ey) / ee);
    const float qx = wx - ex * t;
    const float qy = wy - ey * t;
    const float q2 = qx * qx + qy * qy;
    dist2 = e == 0 ? q2 : fminf(dist2, q2);
    const bool c1 = py >= ay;
    const bool c2 = py < by;
    const bool c3 = ex * wy > ey * wx;
    flips += ((c1 && c2 && c3) || (!c1 && !c2 && !c3)) ? 1 : 0;
  }
  const float odd = (float)(flips % 2);
  return (1.0f - 2.0f * odd) * sqrtf(fmaxf(dist2, 0.0f));
}

// extruded_polygon_distance_p: the min over the volumes (1e9 for an
// inactive one) of the finalEval composition with PolygonXyBias 1.5.
template <bool kShared>
__device__ __forceinline__ float polygons_distance(const Polygons& g,
                                                   float x, float y,
                                                   float z) {
  float best = 0.0f;
  for (int p = 0; p < g.count; ++p) {
    const float distance_xy = polygon_sdf<kShared>(g, p, x, y) + 1.5f;
    const float2 zr = ld2<kShared>(g.z_range + 2 * p);
    const float z0 = zr.x, z1 = zr.y;
    const bool inside_z = (z >= z0) && (z <= z1);
    const float distance_z =
        inside_z ? fmaxf(z - z1, z0 - z) : (z > z1 ? z - z1 : z0 - z);
    float d = distance_xy <= 0.0f
                  ? (distance_z <= 0.0f ? distance_xy + distance_z
                                        : distance_z)
                  : fmaxf(distance_xy, 0.0f) + fmaxf(distance_z, 0.0f);
    d = ld<kShared>(g.active + p) > 0.5f ? d : 1e9f;
    best = p == 0 ? d : fminf(best, d);
  }
  return best;
}

// AnalyticScene.distance_p: maximum_distance min every primitive, then
// the polygons. A record is three 16-byte loads: (type, rotated, cx,
// cy), (cz, sx, sy, sz), the quaternion.
template <bool kShared>
__device__ __forceinline__ float analytic_distance(const Analytic& s,
                                                   float x, float y,
                                                   float z) {
  float d = s.maximum_distance;
  const bool batched = s.batched != 0;
  for (int i = 0; i < s.count; ++i) {
    const float* r = s.records + i * kPrimitiveRecord;
    const float4 r0 = ld4<kShared>(r);
    const float4 r1 = ld4<kShared>(r + 4);
    const int type = (int)r0.x;
    float px = x - r0.z, py = y - r0.w, pz = z - r1.x;
    if (r0.y > 0.5f) {
      const float4 q = ld4<kShared>(r + 8);
      rotate(&px, &py, &pz, q.x, q.y, q.z, q.w);
    }
    const float sx = r1.y, sy = r1.z, sz = r1.w;
    float di;
    switch (type) {
      case kEllipsoid:
        di = sd_ellipsoid(px, py, pz, sx, sy, sz);
        break;
      case kBox:
        di = sd_box(px, py, pz, sx, sy, sz);
        break;
      case kCylinder:
        di = sd_cylinder(px, py, pz, sx, sy, sz);
        break;
      case kSpheroid:
        di = sd_spheroid(px, py, pz, sx, sy, sz);
        break;
      default:
        di = sd_octagon(px, py, pz, sx, sy, sz, batched);
        break;
    }
    d = fminf(d, di);
  }
  if (s.polygons.count > 0) {
    d = fminf(d, polygons_distance<kShared>(s.polygons, x, y, z));
  }
  return d;
}

// Floats of an AnalyticScene's arrays: records, vertices and next
// vertices, z ranges, active flags (each run starts 8-byte aligned).
__host__ __device__ __forceinline__ int analytic_floats(const Analytic& a) {
  const int pe = a.polygons.count * a.polygons.edges;
  return a.count * kPrimitiveRecord + 4 * pe + 3 * a.polygons.count;
}

// The block's copy of the scene in shared memory: the same arrays, the
// pointers moved there; `threads`, the block's size, copy in turn.
__device__ __forceinline__ Analytic stage_analytic(const Analytic& a,
                                                   float* sm, int threads) {
  Analytic s = a;
  const int n_rec = a.count * kPrimitiveRecord;
  const int pe2 = 2 * a.polygons.count * a.polygons.edges;
  const int np = a.polygons.count;
  const float* src[5] = {a.records, a.polygons.vertices,
                         a.polygons.next_vertices, a.polygons.z_range,
                         a.polygons.active};
  const int len[5] = {n_rec, pe2, pe2, 2 * np, np};
  float* dst[5];
  int off = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    dst[k] = sm + off;
    for (int j = threadIdx.x; j < len[k]; j += threads)
      dst[k][j] = __ldg(src[k] + j);
    off += len[k];
  }
  s.records = dst[0];
  s.polygons.vertices = dst[1];
  s.polygons.next_vertices = dst[2];
  s.polygons.z_range = dst[3];
  s.polygons.active = dst[4];
  __syncthreads();
  return s;
}

// ------------------------------------------------------ analytic normals

// The closed-form primitive normals of ops/sdf_primitives.py (nrm_*_p),
// each ending in _nrm_safe: unit length where the vector is longer than
// 1e-9 (its reciprocal times each component), else (0, 0, fallback_z).
__device__ __forceinline__ void nrm_safe(float px, float py, float pz,
                                         float* nx, float* ny, float* nz,
                                         float fallback_z = 1.0f) {
  const float l = sqrtf(px * px + py * py + pz * pz);
  const bool ok = l > 1e-9f;
  const float inv = 1.0f / (ok ? l : 1.0f);
  *nx = ok ? px * inv : 0.0f;
  *ny = ok ? py * inv : 0.0f;
  *nz = ok ? pz * inv : fallback_z;
}

__device__ __forceinline__ void nrm_box(float px, float py, float pz,
                                        float bx, float by, float bz,
                                        float* nx, float* ny, float* nz) {
  const float qx = fabsf(px) - bx;
  const float qy = fabsf(py) - by;
  const float qz = fabsf(pz) - bz;
  const bool outside = (qx > 0.0f) || (qy > 0.0f) || (qz > 0.0f);
  // Inside: the face of the least interior penetration (max q).
  const bool mx = (qx >= qy) && (qx >= qz);
  const bool my = !mx && (qy >= qz);
  const float vx = outside ? sgn(px) * fmaxf(qx, 0.0f)
                           : (mx ? sgn(px) : 0.0f);
  const float vy = outside ? sgn(py) * fmaxf(qy, 0.0f)
                           : (my ? sgn(py) : 0.0f);
  const float vz = outside ? sgn(pz) * fmaxf(qz, 0.0f)
                           : (!(mx || my) ? sgn(pz) : 0.0f);
  nrm_safe(vx, vy, vz, nx, ny, nz);
}

__device__ __forceinline__ void nrm_ellipsoid(float px, float py, float pz,
                                              float rx, float ry, float rz,
                                              float* nx, float* ny,
                                              float* nz) {
  rx = fmaxf(rx, 1e-6f);
  ry = fmaxf(ry, 1e-6f);
  rz = fmaxf(rz, 1e-6f);
  nrm_safe(px / (rx * rx), py / (ry * ry), pz / (rz * rz), nx, ny, nz);
}

__device__ __forceinline__ void nrm_cylinder(float px, float py, float pz,
                                             float sx, float sy, float sz,
                                             float* nx, float* ny,
                                             float* nz) {
  const float r = sqrtf(sx * sx + sy * sy);
  const float lxy = sqrtf(px * px + py * py + 1e-12f);
  const float d_xy = lxy - r;
  const float d_z = fabsf(pz) - sz;
  const bool both_out = (d_xy > 0.0f) && (d_z > 0.0f);
  const bool radial = d_xy >= d_z;
  const float vx = both_out ? px / lxy * fmaxf(d_xy, 0.0f)
                            : (radial ? px / lxy : 0.0f);
  const float vy = both_out ? py / lxy * fmaxf(d_xy, 0.0f)
                            : (radial ? py / lxy : 0.0f);
  const float vz = both_out ? sgn(pz) * fmaxf(d_z, 0.0f)
                            : (radial ? 0.0f : sgn(pz));
  nrm_safe(vx, vy, vz, nx, ny, nz);
}

// Away from the inner core box (the elongation region); deep inside the
// core, +z.
__device__ __forceinline__ void nrm_spheroid(float px, float py, float pz,
                                             float sx, float sy, float sz,
                                             float* nx, float* ny,
                                             float* nz) {
  const float m = fminf(sx, fminf(sy, sz));
  const float ex = sx - m, ey = sy - m, ez = sz - m;
  nrm_safe(px - fminf(fmaxf(px, -ex), ex), py - fminf(fmaxf(py, -ey), ey),
           pz - fminf(fmaxf(pz, -ez), ez), nx, ny, nz);
}

// The tetrahedral finite difference of the planar octagon prism.
__device__ __forceinline__ void nrm_octagon(float px, float py, float pz,
                                            float sx, float sy, float sz,
                                            float* nx, float* ny,
                                            float* nz) {
  const float h = 0.5f;
  const float d1 = sd_octagon(px + h, py - h, pz - h, sx, sy, sz, false);
  const float d2 = sd_octagon(px - h, py - h, pz + h, sx, sy, sz, false);
  const float d3 = sd_octagon(px - h, py + h, pz - h, sx, sy, sz, false);
  const float d4 = sd_octagon(px + h, py + h, pz + h, sx, sy, sz, false);
  nrm_safe(d1 - d2 - d3 + d4, -d1 - d2 + d3 + d4, -d1 + d2 - d3 + d4, nx,
           ny, nz);
}

// AnalyticScene.normal_fast_p of a scene within the unroll limit and
// without polygons (above it the plain version takes central differences
// of the batched distance, with polygons the autograd gradient: both in
// sdf_gradients.cuh): the
// closed-form normal of the nearest primitive, strictly nearer than
// maximum_distance and than every earlier primitive ((0, 0, 0) beyond
// them), rotated back to world space.
template <bool kShared>
__device__ __forceinline__ void analytic_normal_fast(const Analytic& s,
                                                     float x, float y,
                                                     float z, float* nx,
                                                     float* ny, float* nz) {
  float best = s.maximum_distance;
  float bx = 0.0f, by = 0.0f, bz = 0.0f;
  for (int i = 0; i < s.count; ++i) {
    const float* r = s.records + i * kPrimitiveRecord;
    const float4 r0 = ld4<kShared>(r);
    const float4 r1 = ld4<kShared>(r + 4);
    const bool rotated = r0.y > 0.5f;
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    float px = x - r0.z, py = y - r0.w, pz = z - r1.x;
    if (rotated) {
      q = ld4<kShared>(r + 8);
      rotate(&px, &py, &pz, q.x, q.y, q.z, q.w);
    }
    const float sx = r1.y, sy = r1.z, sz = r1.w;
    float d, ix, iy, iz;
    switch ((int)r0.x) {
      case kEllipsoid:
        d = sd_ellipsoid(px, py, pz, sx, sy, sz);
        nrm_ellipsoid(px, py, pz, sx, sy, sz, &ix, &iy, &iz);
        break;
      case kBox:
        d = sd_box(px, py, pz, sx, sy, sz);
        nrm_box(px, py, pz, sx, sy, sz, &ix, &iy, &iz);
        break;
      case kCylinder:
        d = sd_cylinder(px, py, pz, sx, sy, sz);
        nrm_cylinder(px, py, pz, sx, sy, sz, &ix, &iy, &iz);
        break;
      case kSpheroid:
        d = sd_spheroid(px, py, pz, sx, sy, sz);
        nrm_spheroid(px, py, pz, sx, sy, sz, &ix, &iy, &iz);
        break;
      default:
        d = sd_octagon(px, py, pz, sx, sy, sz, false);
        nrm_octagon(px, py, pz, sx, sy, sz, &ix, &iy, &iz);
        break;
    }
    if (rotated) rotate(&ix, &iy, &iz, -q.x, -q.y, -q.z, q.w);
    if (d < best) {
      bx = ix;
      by = iy;
      bz = iz;
    }
    best = fminf(best, d);
  }
  *nx = bx;
  *ny = by;
  *nz = bz;
}

// ---------------------------------------------------------------- column

struct Column {
  const float* pack;  // columns_kernel.pack_maps of the 5 maps
  int hc, wc;
  illum_columns::Geometry g;
};

__device__ __forceinline__ float column_distance(const Column& c, float x,
                                                 float y, float z) {
  return illum_columns::column_distance(c.pack, c.hc, c.wc, c.g, x, y, z);
}

// ------------------------------------------------------------ the table

// The field of a launch, whichever kind it is.
struct FieldTable {
  Volume volume;
  Analytic analytic;
  Column column;
};

// A launch's field from the wrapper's table (the kind, then its ints,
// floats and pointers, lighting/cone_trace_kernel.py:field_scalars'
// order): kind 0 an SdfVolume (slices, height, width; ex, ey, ez,
// z_offset, z_to_slice, scale_x, scale_y; the tap pack, max_valid_z),
// 1 an AnalyticScene (count, batched, polygons, edges; maximum_distance;
// records, vertices, next vertices, z ranges, active flags), 2 a
// ColumnField (hc, wc; the 12 geometry floats; the map pack). False for
// another kind.
inline bool fields_from(int kind, const long long* fi, const float* ff,
                        const void* const* fp, FieldTable* f) {
  *f = FieldTable{};
  if (kind == 0) {
    f->volume.pack = (const float4*)fp[0];
    f->volume.max_valid_z = (const float*)fp[1];
    f->volume.slices = (int)fi[0];
    f->volume.height = (int)fi[1];
    f->volume.width = (int)fi[2];
    f->volume.ex = ff[0];
    f->volume.ey = ff[1];
    f->volume.ez = ff[2];
    f->volume.z_offset = ff[3];
    f->volume.z_to_slice = ff[4];
    f->volume.scale_x = ff[5];
    f->volume.scale_y = ff[6];
  } else if (kind == 1) {
    f->analytic.records = (const float*)fp[0];
    f->analytic.count = (int)fi[0];
    f->analytic.batched = (int)fi[1];
    f->analytic.polygons.count = (int)fi[2];
    f->analytic.polygons.edges = (int)fi[3];
    f->analytic.polygons.vertices = (const float*)fp[1];
    f->analytic.polygons.next_vertices = (const float*)fp[2];
    f->analytic.polygons.z_range = (const float*)fp[3];
    f->analytic.polygons.active = (const float*)fp[4];
    f->analytic.maximum_distance = ff[0];
  } else if (kind == 2) {
    f->column.pack = (const float*)fp[0];
    f->column.hc = (int)fi[0];
    f->column.wc = (int)fi[1];
    f->column.g = illum_columns::geometry_from(ff);
  } else {
    return false;
  }
  return true;
}

}  // namespace illum_fields
