// The AnalyticScene's collision normals that are not closed forms, as
// device functions over sdf_fields.cuh's records (collide_integrate.cu,
// K4, on a scene read from device memory):
//   * `analytic_normal_central`: sdf/analytic.py:AnalyticScene.
//     normal_fast_p above the unroll limit without polygons, the central
//     differences (step 0.05) of the batched distance;
//   * `analytic_normal_autograd`: AnalyticScene.normal_p, which
//     normal_fast_p takes on a scene with polygons: the unit autograd
//     gradient of distance_p, zero where it vanishes.
// The autograd gradient is carried forward beside each value (`Dual`):
// every operation of the planar forms (ops/sdf_primitives.py `*_p`,
// sdf/height_volume.py:polygon_sdf_2d_p and extruded_polygon_distance_p)
// takes the derivative PyTorch's backward rule gives it, ties included
// (maximum / minimum split the gradient in half, amin evenly, a clamp
// passes it on its bounds, abs and sign at 0 give 0). The values round as
// sdf_fields.cuh's (the file is compiled with -fmad=false), so the
// nearest primitive and every branch are those of the distance; the
// gradient's sums round in another order than the backward pass, which
// the card tests count and bound. Above the unroll limit the batched
// forms' values are taken (the octagon's), their gradient as the planar
// forms'.

#pragma once

#include <cuda_runtime.h>

#include "sdf_fields.cuh"

namespace illum_fields {

// A value and its gradient in world x, y, z.
struct Dual {
  float v, x, y, z;
};

__device__ __forceinline__ Dual dconst(float v) {
  return Dual{v, 0.0f, 0.0f, 0.0f};
}

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return Dual{a.v + b.v, a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return Dual{a.v - b.v, a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ Dual operator+(Dual a, float c) {
  return Dual{a.v + c, a.x, a.y, a.z};
}

__device__ __forceinline__ Dual operator-(Dual a, float c) {
  return Dual{a.v - c, a.x, a.y, a.z};
}

__device__ __forceinline__ Dual operator-(float c, Dual a) {
  return Dual{c - a.v, -a.x, -a.y, -a.z};
}

__device__ __forceinline__ Dual operator*(Dual a, float c) {
  return Dual{a.v * c, a.x * c, a.y * c, a.z * c};
}

__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual{a.v * b.v, a.x * b.v + b.x * a.v, a.y * b.v + b.y * a.v,
              a.z * b.v + b.z * a.v};
}

__device__ __forceinline__ Dual operator/(Dual a, float c) {
  return Dual{a.v / c, a.x / c, a.y / c, a.z / c};
}

__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float k = a.v / (b.v * b.v);
  return Dual{a.v / b.v, a.x / b.v - b.x * k, a.y / b.v - b.y * k,
              a.z / b.v - b.z * k};
}

__device__ __forceinline__ Dual dsqrt(Dual a) {
  const float r = sqrtf(a.v);
  const float k = 2.0f * r;
  return Dual{r, a.x / k, a.y / k, a.z / k};
}

__device__ __forceinline__ Dual dabs(Dual a) {
  const float s = sgn(a.v);
  return Dual{fabsf(a.v), a.x * s, a.y * s, a.z * s};
}

__device__ __forceinline__ Dual dmax(Dual a, Dual b) {
  if (a.v > b.v) return a;
  if (b.v > a.v) return b;
  return Dual{a.v, (a.x + b.x) * 0.5f, (a.y + b.y) * 0.5f,
              (a.z + b.z) * 0.5f};
}

__device__ __forceinline__ Dual dmin(Dual a, Dual b) {
  if (a.v < b.v) return a;
  if (b.v < a.v) return b;
  return Dual{a.v, (a.x + b.x) * 0.5f, (a.y + b.y) * 0.5f,
              (a.z + b.z) * 0.5f};
}

// torch.clamp(a, max=m), torch.clamp(a, min=m), torch.clamp(a, lo, hi).
__device__ __forceinline__ Dual clamp_max(Dual a, float m) {
  return a.v <= m ? a : dconst(m);
}

__device__ __forceinline__ Dual clamp_min(Dual a, float m) {
  return a.v >= m ? a : dconst(m);
}

__device__ __forceinline__ Dual dclamp(Dual a, float lo, float hi) {
  return (a.v >= lo && a.v <= hi) ? a : dconst(fminf(fmaxf(a.v, lo), hi));
}

__device__ __forceinline__ Dual dlen3(Dual x, Dual y, Dual z) {
  return dsqrt(x * x + y * y + z * z + 1e-12f);
}

__device__ __forceinline__ Dual dlen2(Dual x, Dual y) {
  return dsqrt(x * x + y * y + 1e-12f);
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ Dual dsd_box(Dual px, Dual py, Dual pz,
                                        float sx, float sy, float sz) {
  const Dual dx = dabs(px) - sx;
  const Dual dy = dabs(py) - sy;
  const Dual dz = dabs(pz) - sz;
  const Dual inside = clamp_max(dmax(dx, dmax(dy, dz)), 0.0f);
  const Dual outside = dlen3(clamp_min(dx, 0.0f), clamp_min(dy, 0.0f),
                             clamp_min(dz, 0.0f));
  return inside + outside;
}

__device__ __forceinline__ Dual dsd_ellipsoid(Dual px, Dual py, Dual pz,
                                              float sx, float sy, float sz) {
  sx = fmaxf(sx, 1e-6f);
  sy = fmaxf(sy, 1e-6f);
  sz = fmaxf(sz, 1e-6f);
  const Dual k0 = dlen3(px / sx, py / sy, pz / sz);
  const Dual k1 = dlen3(px / (sx * sx), py / (sy * sy), pz / (sz * sz));
  const float rmin = fminf(sx, fminf(sy, sz));
  const Dual near_ = (k0 - 1.0f) * rmin;
  const Dual far_ = k0 * (k0 - 1.0f) / clamp_min(k1, 1e-12f);
  return k0.v < 1.0f ? near_ : far_;
}

__device__ __forceinline__ Dual delongate(Dual px, Dual py, Dual pz,
                                          float hx, float hy, float hz,
                                          Dual* qx, Dual* qy, Dual* qz) {
  const Dual ax = dabs(px) - hx;
  const Dual ay = dabs(py) - hy;
  const Dual az = dabs(pz) - hz;
  *qx = clamp_min(ax, 0.0f) * sgn(px.v);
  *qy = clamp_min(ay, 0.0f) * sgn(py.v);
  *qz = clamp_min(az, 0.0f) * sgn(pz.v);
  return clamp_max(dmax(ax, dmax(ay, az)), 0.0f);
}

__device__ __forceinline__ Dual dsd_spheroid(Dual px, Dual py, Dual pz,
                                             float sx, float sy, float sz) {
  const float ms = fminf(sx, fminf(sy, sz));
  Dual qx, qy, qz;
  const Dual w = delongate(px, py, pz, sx - ms, sy - ms, sz - ms, &qx, &qy,
                           &qz);
  return w + (dlen3(qx, qy, qz) - ms);
}

__device__ __forceinline__ Dual dsd_cylinder(Dual px, Dual py, Dual pz,
                                             float sx, float sy, float sz) {
  const float r = len2(sx, sy);
  const Dual d_xy = dlen2(px, py) - r;
  const Dual d_z = dabs(pz) - sz;
  const Dual inside = clamp_max(dmax(d_xy, d_z), 0.0f);
  const Dual outside = dlen2(clamp_min(d_xy, 0.0f), clamp_min(d_z, 0.0f));
  return inside + outside;
}

// sd_octagon's two forms (see there).
__device__ __forceinline__ Dual dsd_octagon(Dual px, Dual py, Dual pz,
                                            float sx, float sy, float sz,
                                            bool batched) {
  const float ms = fminf(sx, sy);
  Dual qx, qy, qz;
  const Dual w = delongate(px, py, pz, sx - ms, sy - ms, 0.0f, &qx, &qy,
                           &qz);
  const float kx = -0.9238795325f;
  const float ky = 0.3826834323f;
  const float kz = 0.4142135623f;
  Dual ax = dabs(qx);
  Dual ay = dabs(qy);
  const Dual az = dabs(qz);
  const Dual m1 = clamp_max(ax * kx + ay * ky, 0.0f) * 2.0f;
  ax = ax - m1 * kx;
  ay = ay - m1 * ky;
  const Dual m2 = clamp_max(ax * -kx + ay * ky, 0.0f) * 2.0f;
  ax = ax - m2 * -kx;
  ay = ay - m2 * ky;
  ax = ax - dmin(dmax(ax, dconst(-kz * ms)), dconst(kz * ms));
  ay = ay - ms;
  const Dual root = batched ? dsqrt(ax * ax + ay * ay)
                            : dsqrt(ax * ax + ay * ay + 1e-12f);
  const Dual dxo = root * sgn(ay.v);
  const Dual dzo = az - sz;
  const Dual inside = clamp_max(dmax(dxo, dzo), 0.0f);
  const Dual outside = dlen2(clamp_min(dxo, 0.0f), clamp_min(dzo, 0.0f));
  return batched ? w + (inside + outside) : w + inside + outside;
}

// rotate() of a point and of its gradient's three columns (a linear map).
__device__ __forceinline__ void drotate(Dual* px, Dual* py, Dual* pz,
                                        float4 q) {
  rotate(&px->v, &py->v, &pz->v, q.x, q.y, q.z, q.w);
  rotate(&px->x, &py->x, &pz->x, q.x, q.y, q.z, q.w);
  rotate(&px->y, &py->y, &pz->y, q.x, q.y, q.z, q.w);
  rotate(&px->z, &py->z, &pz->z, q.x, q.y, q.z, q.w);
}

// -------------------------------------------------------------- polygons

// polygon_sdf of polygon p; the squared distance's min over the edges
// (amin) shares the gradient evenly among the edges that tie.
template <bool kShared>
__device__ __forceinline__ Dual dpolygon_sdf(const Polygons& g, int p,
                                             Dual px, Dual py) {
  const float* a = g.vertices + p * g.edges * 2;
  const float* b = g.next_vertices + p * g.edges * 2;
  Dual dist2 = dconst(0.0f);
  int ties = 0;
  int flips = 0;
  for (int e = 0; e < g.edges; ++e) {
    const float2 va = ld2<kShared>(a + 2 * e);
    const float2 vb = ld2<kShared>(b + 2 * e);
    const float ax = va.x, ay = va.y, bx = vb.x, by = vb.y;
    const float ex = bx - ax, ey = by - ay;
    const Dual wx = px - ax, wy = py - ay;
    const float ee = fmaxf(ex * ex + ey * ey, 1e-12f);
    const Dual t = dclamp((wx * ex + wy * ey) / ee, 0.0f, 1.0f);
    const Dual qx = wx - t * ex;
    const Dual qy = wy - t * ey;
    const Dual q2 = qx * qx + qy * qy;
    if (e == 0 || q2.v < dist2.v) {
      dist2 = q2;
      ties = 1;
    } else if (q2.v == dist2.v) {
      dist2 = Dual{dist2.v, dist2.x + q2.x, dist2.y + q2.y, dist2.z + q2.z};
      ++ties;
    }
    const bool c1 = py.v >= ay;
    const bool c2 = py.v < by;
    const bool c3 = ex * wy.v > ey * wx.v;
    flips += ((c1 && c2 && c3) || (!c1 && !c2 && !c3)) ? 1 : 0;
  }
  if (ties > 1) {
    const float k = (float)ties;
    dist2 = Dual{dist2.v, dist2.x / k, dist2.y / k, dist2.z / k};
  }
  const float odd = (float)(flips % 2);
  return dsqrt(clamp_min(dist2, 0.0f)) * (1.0f - 2.0f * odd);
}

template <bool kShared>
__device__ __forceinline__ Dual dpolygons_distance(const Polygons& g,
                                                   Dual x, Dual y, Dual z) {
  Dual best = dconst(0.0f);
  for (int p = 0; p < g.count; ++p) {
    const Dual distance_xy = dpolygon_sdf<kShared>(g, p, x, y) + 1.5f;
    const float2 zr = ld2<kShared>(g.z_range + 2 * p);
    const float z0 = zr.x, z1 = zr.y;
    const bool inside_z = (z.v >= z0) && (z.v <= z1);
    const Dual distance_z =
        inside_z ? dmax(z - z1, z0 - z) : (z.v > z1 ? z - z1 : z0 - z);
    Dual d = distance_xy.v <= 0.0f
                 ? (distance_z.v <= 0.0f ? distance_xy + distance_z
                                         : distance_z)
                 : clamp_min(distance_xy, 0.0f) +
                       clamp_min(distance_z, 0.0f);
    d = ld<kShared>(g.active + p) > 0.5f ? d : dconst(1e9f);
    best = p == 0 ? d : dmin(best, d);
  }
  return best;
}

// ----------------------------------------------------------------- scene

// analytic_distance with its gradient.
template <bool kShared>
__device__ __forceinline__ Dual analytic_distance_dual(const Analytic& s,
                                                       float x, float y,
                                                       float z) {
  Dual d = dconst(s.maximum_distance);
  const bool batched = s.batched != 0;
  for (int i = 0; i < s.count; ++i) {
    const float* r = s.records + i * kPrimitiveRecord;
    const float4 r0 = ld4<kShared>(r);
    const float4 r1 = ld4<kShared>(r + 4);
    Dual px = Dual{x - r0.z, 1.0f, 0.0f, 0.0f};
    Dual py = Dual{y - r0.w, 0.0f, 1.0f, 0.0f};
    Dual pz = Dual{z - r1.x, 0.0f, 0.0f, 1.0f};
    if (r0.y > 0.5f) drotate(&px, &py, &pz, ld4<kShared>(r + 8));
    const float sx = r1.y, sy = r1.z, sz = r1.w;
    Dual di;
    switch ((int)r0.x) {
      case kEllipsoid:
        di = dsd_ellipsoid(px, py, pz, sx, sy, sz);
        break;
      case kBox:
        di = dsd_box(px, py, pz, sx, sy, sz);
        break;
      case kCylinder:
        di = dsd_cylinder(px, py, pz, sx, sy, sz);
        break;
      case kSpheroid:
        di = dsd_spheroid(px, py, pz, sx, sy, sz);
        break;
      default:
        di = dsd_octagon(px, py, pz, sx, sy, sz, batched);
        break;
    }
    d = dmin(d, di);
  }
  if (s.polygons.count > 0) {
    d = dmin(d, dpolygons_distance<kShared>(
                    s.polygons, Dual{x, 1.0f, 0.0f, 0.0f},
                    Dual{y, 0.0f, 1.0f, 0.0f}, Dual{z, 0.0f, 0.0f, 1.0f}));
  }
  return d;
}

// AnalyticScene.normal_p: the gradient over its length where that
// exceeds 1e-9, else (0, 0, 0).
template <bool kShared>
__device__ __forceinline__ void analytic_normal_autograd(
    const Analytic& s, float x, float y, float z, float* nx, float* ny,
    float* nz) {
  const Dual d = analytic_distance_dual<kShared>(s, x, y, z);
  const float norm = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  const bool ok = norm > 1e-9f;
  const float safe = fmaxf(norm, 1e-9f);
  *nx = ok ? d.x / safe : 0.0f;
  *ny = ok ? d.y / safe : 0.0f;
  *nz = ok ? d.z / safe : 0.0f;
}

// normal_fast_p above the unroll limit: central differences of the
// (batched) distance, step 0.05, over their length (+1e-12).
template <bool kShared>
__device__ __forceinline__ void analytic_normal_central(
    const Analytic& s, float x, float y, float z, float* nx, float* ny,
    float* nz) {
  const float e = 0.05f;
  const float gx = analytic_distance<kShared>(s, x + e, y, z) -
                   analytic_distance<kShared>(s, x - e, y, z);
  const float gy = analytic_distance<kShared>(s, x, y + e, z) -
                   analytic_distance<kShared>(s, x, y - e, z);
  const float gz = analytic_distance<kShared>(s, x, y, z + e) -
                   analytic_distance<kShared>(s, x, y, z - e);
  const float inv = 1.0f / sqrtf(gx * gx + gy * gy + gz * gz + 1e-12f);
  *nx = gx * inv;
  *ny = gy * inv;
  *nz = gz * inv;
}

}  // namespace illum_fields
