// K4c: the particle tick's modifier chain for Hopper (sm_90a).
//
// Replaces, on the card, the eager chain of particles/transforms.py's
// modifiers (`apply_modifiers_reference`, which `apply_modifiers` runs on
// the CPU): FMA, MatrixMultiply (GeometricTransform runs as it), Gravity,
// VectorField and Noise (temporal and spatial), each weighed by its area
// and gated by its filter. Eagerly each modifier is 40-240 small kernels
// over the 1M slots, launched by the host one at a time (about 500 a tick
// of the config-4 system; the JAX package's counterpart,
// illuminant_tpu/particles/transforms.py, is part of one XLA fusion).
//
// One thread a slot. It loads the slot's position and velocity rows once
// (two 16-byte loads), runs the step program in registers in the list's
// order, each step reading the rows the previous one left, and writes both
// rows once: 64 B a slot, ~0.02 ms at 1M slots from device memory, plus
// the texels the fields give (the VectorField's bilinear taps, the noise's
// point or bilinear samples of the RandomField), which the L2 holds.
//
// The step program is a kernel parameter: each step's kind, its first
// uniform segment and its attractor count, and the field it samples
// (device pointer, height, width). A block first copies every segment
// (the SystemUniforms' global settings, then each step's uniform tensors
// where they lie on the device, one thread a segment) into shared memory
// at the offsets the host lays out (modifier_kernel.SEGMENTS; the sizes
// live there alone), so a tick reads nothing on the host and builds no
// table on the device. A list longer than one program's limits runs as a
// few launches of consecutive steps (modifier_kernel.launch_plan).
//
// Rounding: the file is compiled with -fmad=false, division and sqrtf are
// IEEE, and every formula keeps the eager operation order: torch.where's
// selects, _time_weight's (w * dt) * cps, _steer's lerp and its unit
// velocity, the noise draws' lerp, the bilinear taps' two lerps. torch.sum
// over a 3-wide axis adds (x^2 + z^2) + y^2 on the card (its two-lane
// split of the axis; K4 and K4b add it so too); a 2-wide one x + y. The
// sum over the attractors (Gravity.fx's loop, torch.sum over dim 1 of
// (N, A, 3)) follows the card's reduction over a strided axis
// (`attractor_sum`): attractor a into accumulator a % 4, then the four in
// order (tests/test_torch_modifier_cuda.py pins both orders against
// torch.sum on the card). The area distances are ops/sdf_primitives.py's batched
// forms (evaluate_by_type): the cylinder, the octagon and the rotation are
// sdf_fields.cuh's, which equal them bit for bit; the box, the ellipsoid
// and the spheroid take their 3-wide lengths in the card's order here. So
// the kernel equals the eager chain run on the card bit for bit
// (tests/test_torch_modifier_cuda.py) for every kind, area type and count
// of attractors; the card tests count the slots that differ and hold that
// count to 0.
//
// Not fused into K4 (csrc/collide_integrate.cu): K4 sits at 64 registers
// with a few spilled bytes and a field kind x substep instance matrix, and
// the modifiers' 64 B a slot in a separate pass cost ~0.02 ms and one
// launch.

#include <cuda_runtime.h>

#include "sdf_fields.cuh"

namespace {

using illum_fields::rotate;
using illum_fields::sgn;

constexpr int kThreads = 256;
// A program's limits: steps, uniform segments (the system's included) and
// the 32-bit words of its copy in shared memory.
constexpr int kMaxSteps = 16;
constexpr int kMaxSegments = 192;
constexpr int kMaxWords = 2048;
// Gravity.fx:3.
constexpr int kMaxAttractors = 16;

// The step kinds, in modifier_kernel.KINDS' order.
enum Kind { kFMA = 0, kMatrixMultiply, kGravity, kVectorField, kNoise,
            kSpatialNoise, kKinds };

// Each kind's segments, in modifier_kernel.SEGMENTS' order: the area's
// (AreaUniforms) first where the kind has one.
enum AreaSegment { kAreaType = 0, kAreaCenter, kAreaSize, kAreaFalloff,
                   kAreaRotation, kAreaStrength, kAreaSegments };
enum FMASegment { kFMAPositionAdd = kAreaSegments, kFMAPositionMultiply,
                  kFMAVelocityAdd, kFMAVelocityMultiply, kFMACycles,
                  kFMACategory, kFMASegments };
enum MatrixSegment { kMatrixPosition = kAreaSegments, kMatrixVelocity,
                     kMatrixCycles, kMatrixCategory, kMatrixSegments };
enum GravitySegment { kGravityPositions = 0, kGravityRadiuses,
                      kGravityStrengths, kGravityFalloffs, kGravityActive,
                      kGravityMaximum, kGravityCategory, kGravitySegments };
enum FieldSegment { kFieldScale = kAreaSegments, kFieldOffset,
                    kFieldVelocityScale, kFieldReplace, kFieldCycles,
                    kFieldCategory, kFieldSegments };
enum NoiseSegment { kNoisePositionOffset = kAreaSegments,
                    kNoisePositionMinimum, kNoisePositionScale,
                    kNoiseVelocityOffset, kNoiseVelocityMinimum,
                    kNoiseVelocityScale, kNoiseReplace, kNoiseCycles,
                    kNoiseLerp, kNoiseOffset, kNoiseNextOffset,
                    kNoiseSpaceScale, kNoiseCategory, kNoiseSegments };

struct Step {
  int kind;
  int first;       // its first segment in the program
  int attractors;  // Gravity: A (padded to a multiple of 2)
  int height, width;    // the sampled field's (VectorField, noise)
  const float4* field;  // (H, W, 4) float32, or null
};

struct Program {
  int steps, segments;
  Step step[kMaxSteps];
  const unsigned* ptr[kMaxSegments];  // segment 0: global_settings
  int offset[kMaxSegments + 1];       // each segment's first word; the end
};

struct Launch {
  const float4* position;  // (N, 4) in
  const float4* velocity;
  float4* out_position;  // (N, 4) out (may be the inputs)
  float4* out_velocity;
  long long n;
};

// torch.clamp / torch.maximum / torch.minimum on float32: NaN propagates.
__device__ __forceinline__ float tclamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float tmax(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float tmin(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}
// torch.remainder: Python's sign rules (int64 and float32).
__device__ __forceinline__ long long mod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
__device__ __forceinline__ float torch_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}
// torch.sum over a 3-wide axis on the card: (x + z) + y.
__device__ __forceinline__ float sum3(float x, float y, float z) {
  return (x + z) + y;
}
// sdf_primitives._length of a 3-vector.
__device__ __forceinline__ float length3(float x, float y, float z) {
  return sqrtf(sum3(x * x, y * y, z * z) + 1e-12f);
}

// The staged segments of one step: word k of its segment s.
struct Uniforms {
  const unsigned* words;
  const int* offset;  // the step's offsets (the program's from `first`)
  __device__ __forceinline__ float f(int s, int k = 0) const {
    return __uint_as_float(words[offset[s] + k]);
  }
  __device__ __forceinline__ float4 f4(int s) const {
    return make_float4(f(s, 0), f(s, 1), f(s, 2), f(s, 3));
  }
  __device__ __forceinline__ int i(int s) const {
    return (int)words[offset[s]];
  }
};

// ------------------------------------------------------------------ area

// sdf_primitives.sd_box (batched).
__device__ __forceinline__ float box(float px, float py, float pz, float sx,
                                     float sy, float sz) {
  const float dx = fabsf(px) - sx, dy = fabsf(py) - sy,
              dz = fabsf(pz) - sz;
  const float outside = length3(tmax(dx, 0.0f), tmax(dy, 0.0f),
                                tmax(dz, 0.0f));
  const float inside = tmin(fmaxf(fmaxf(dx, dy), dz), 0.0f);
  return inside + outside;
}

// sdf_primitives.sd_ellipsoid (batched) of size clamped at 1e-6.
__device__ __forceinline__ float ellipsoid(float px, float py, float pz,
                                           float sx, float sy, float sz) {
  sx = tmax(sx, 1e-6f);
  sy = tmax(sy, 1e-6f);
  sz = tmax(sz, 1e-6f);
  const float k0 = length3(px / sx, py / sy, pz / sz);
  const float k1 = length3(px / (sx * sx), py / (sy * sy), pz / (sz * sz));
  const float near_ = (k0 - 1.0f) * fminf(fminf(sx, sy), sz);
  const float far_ = k0 * (k0 - 1.0f) / tmax(k1, 1e-12f);
  return k0 < 1.0f ? near_ : far_;
}

// sdf_primitives.sd_spheroid (batched).
__device__ __forceinline__ float spheroid(float px, float py, float pz,
                                          float sx, float sy, float sz) {
  const float ms = fminf(fminf(sx, sy), sz);
  float qx, qy, qz;
  const float w = illum_fields::elongate(px, py, pz, sx - ms, sy - ms,
                                         sz - ms, &qx, &qy, &qz);
  return w + (length3(qx, qy, qz) - ms);
}

// transforms.area_weight (computeWeight, FMA.fx:15-20): strength at every
// position for type 0 (no distance evaluated); else the distance of
// evaluate_by_type's |type| (1e9 for none) through 1 - saturate(d /
// max(falloff, 1)), times strength.
__device__ __forceinline__ float area_weight(const Uniforms& u, float4 p) {
  const int type = u.i(kAreaType);
  const float strength = u.f(kAreaStrength);
  if (type == 0) return 1.0f * strength;
  float x = p.x - u.f(kAreaCenter, 0), y = p.y - u.f(kAreaCenter, 1),
        z = p.z - u.f(kAreaCenter, 2);
  rotate(&x, &y, &z, u.f(kAreaRotation, 0), u.f(kAreaRotation, 1),
         u.f(kAreaRotation, 2), u.f(kAreaRotation, 3));
  const float sx = u.f(kAreaSize, 0), sy = u.f(kAreaSize, 1),
              sz = u.f(kAreaSize, 2);
  float d = 1e9f;
  switch (type < 0 ? -type : type) {
    case 1: d = ellipsoid(x, y, z, sx, sy, sz); break;
    case 2: d = box(x, y, z, sx, sy, sz); break;
    case 3: d = illum_fields::sd_cylinder(x, y, z, sx, sy, sz); break;
    case 4: d = spheroid(x, y, z, sx, sy, sz); break;
    case 5: d = illum_fields::sd_octagon(x, y, z, sx, sy, sz, true); break;
    default: break;
  }
  const float w = 1.0f - tclamp(d / tmax(u.f(kAreaFalloff), 1.0f), 0.0f,
                                1.0f);
  return w * strength;
}

// transforms._time_weight: (w * dt) * cps where cps >= 0, else w.
__device__ __forceinline__ float time_weight(float w, float cps, float dt) {
  return cps >= 0.0f ? w * dt * cps : w;
}

__device__ __forceinline__ bool in_filter(const Uniforms& u, int s,
                                          float category) {
  return category >= u.f(s, 0) && category <= u.f(s, 1);
}

// transforms._steer: the velocity lerped towards delta by w (replace) or
// plus delta * t, then plus |delta.w| along the old velocity's unit.
__device__ __forceinline__ float4 steer(float4 v, float4 d, float w,
                                        float t, float replace) {
  float nx, ny, nz;
  if (replace > 0.5f) {
    nx = v.x + (d.x - v.x) * w;
    ny = v.y + (d.y - v.y) * w;
    nz = v.z + (d.z - v.z) * w;
  } else {
    nx = v.x + d.x * t;
    ny = v.y + d.y * t;
    nz = v.z + d.z * t;
  }
  const float len = sqrtf(tmax(sum3(v.x * v.x, v.y * v.y, v.z * v.z),
                               1e-12f));
  return make_float4(nx + v.x / len * d.w, ny + v.y / len * d.w,
                     nz + v.z / len * d.w, v.w);
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  return make_float4(a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
                     a.z + (b.z - a.z) * t, a.w + (b.w - a.w) * t);
}

// ops/noise.py:point_sample at rate 1 (wrap addressing).
__device__ __forceinline__ float4 point_sample(const Step& st, float x,
                                               float y, float ox, float oy) {
  const long long xi = mod((long long)floorf(x * 1.0f + ox), st.width);
  const long long yi = mod((long long)floorf(y * 1.0f + oy), st.height);
  return __ldg(st.field + yi * st.width + xi);
}

// ops/noise.py:bilinear_sample (wrap addressing, texel centres at +0.5).
__device__ __forceinline__ float4 bilinear_sample(const Step& st, float x,
                                                  float y, float ox,
                                                  float oy, float rx,
                                                  float ry) {
  const float tx = (x * rx + ox) - 0.5f, ty = (y * ry + oy) - 0.5f;
  const float x0 = floorf(tx), y0 = floorf(ty);
  const float wx = tx - x0, wy = ty - y0;
  const long long x0i = mod((long long)x0, st.width);
  const long long x1i = mod(x0i + 1, st.width);
  const long long y0i = mod((long long)y0, st.height);
  const long long y1i = mod(y0i + 1, st.height);
  const float4 v00 = __ldg(st.field + y0i * st.width + x0i);
  const float4 v01 = __ldg(st.field + y0i * st.width + x1i);
  const float4 v10 = __ldg(st.field + y1i * st.width + x0i);
  const float4 v11 = __ldg(st.field + y1i * st.width + x1i);
  return lerp4(lerp4(v00, v01, wx), lerp4(v10, v11, wx), wy);
}

// ----------------------------------------------------------------- steps

// apply_fma: p += (p * multiply + add - p) * t, v alike, on live slots in
// the filter (all four lanes, as the eager body).
__device__ __forceinline__ void fma_step(const Uniforms& u, float dt,
                                         float4& p, float4& v) {
  const float t = time_weight(area_weight(u, p), u.f(kFMACycles), dt);
  if (!(p.w > 0.0f && in_filter(u, kFMACategory, v.w))) return;
  const float4 pm = u.f4(kFMAPositionMultiply), pa = u.f4(kFMAPositionAdd);
  const float4 vm = u.f4(kFMAVelocityMultiply), va = u.f4(kFMAVelocityAdd);
  p = make_float4(p.x + (p.x * pm.x + pa.x - p.x) * t,
                  p.y + (p.y * pm.y + pa.y - p.y) * t,
                  p.z + (p.z * pm.z + pa.z - p.z) * t,
                  p.w + (p.w * pm.w + pa.w - p.w) * t);
  v = make_float4(v.x + (v.x * vm.x + va.x - v.x) * t,
                  v.y + (v.y * vm.y + va.y - v.y) * t,
                  v.z + (v.z * vm.z + va.z - v.z) * t,
                  v.w + (v.w * vm.w + va.w - v.w) * t);
}

// coords.mul_point_rows: mul(float4(r.xyz, 1), M) with r.w kept, then
// r + (that - r) * t.
__device__ __forceinline__ float4 matrix_row(const Uniforms& u, int s,
                                             float4 r, float t) {
  const float x = r.x * u.f(s, 0) + r.y * u.f(s, 4) + r.z * u.f(s, 8) +
                  u.f(s, 12);
  const float y = r.x * u.f(s, 1) + r.y * u.f(s, 5) + r.z * u.f(s, 9) +
                  u.f(s, 13);
  const float z = r.x * u.f(s, 2) + r.y * u.f(s, 6) + r.z * u.f(s, 10) +
                  u.f(s, 14);
  return make_float4(r.x + (x - r.x) * t, r.y + (y - r.y) * t,
                     r.z + (z - r.z) * t, r.w + (r.w - r.w) * t);
}

// apply_matrix_multiply.
__device__ __forceinline__ void matrix_step(const Uniforms& u, float dt,
                                            float4& p, float4& v) {
  const float t = time_weight(area_weight(u, p), u.f(kMatrixCycles), dt);
  if (!(p.w > 0.0f && in_filter(u, kMatrixCategory, v.w))) return;
  p = matrix_row(u, kMatrixPosition, p, t);
  v = matrix_row(u, kMatrixVelocity, v, t);
}

// Attractor a's acceleration (Gravity.fx:12-50, apply_gravity's (N, A, 3)
// term): to_center / dist * (attraction * strength * active).
__device__ __forceinline__ float3 attraction(const Uniforms& u, int a,
                                             float4 p, float dt) {
  const float tx = u.f(kGravityPositions, 3 * a) - p.x;
  const float ty = u.f(kGravityPositions, 3 * a + 1) - p.y;
  const float tz = u.f(kGravityPositions, 3 * a + 2) - p.z;
  const float dist_sq = sum3(tx * tx, ty * ty, tz * tz);
  const float dist = sqrtf(tmax(dist_sq, 1e-12f));
  const float radius = u.f(kGravityRadiuses, a);
  const float falloff = u.f(kGravityFalloffs, a);
  const float linear = 1.0f - tclamp(dist / tmax(radius, 1e-6f), 0.0f, 1.0f);
  const float ramped = (falloff >= 1.5f ? linear * linear : linear) * dt;
  const float physical = 1.0f / tmax(dist_sq - radius, 0.001f);
  const float scale = (falloff >= 0.5f ? ramped : physical) *
                      u.f(kGravityStrengths, a) * u.f(kGravityActive, a);
  return make_float3(tx / dist * scale, ty / dist * scale, tz / dist * scale);
}

__device__ __forceinline__ void add3(float3& a, float3 b) {
  a.x = a.x + b.x;
  a.y = a.y + b.y;
  a.z = a.z + b.z;
}

// torch.sum over the attractors (dim 1 of (N, A, 3), a strided axis) in
// the card's order: attractor a added into accumulator a % 4 (the
// reduction's loop of four loads, then the rest), then the four added in
// order.
__device__ __forceinline__ float3 attractor_sum(const Uniforms& u, int n,
                                                float4 p, float dt) {
  float3 acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = make_float3(0.0f, 0.0f, 0.0f);
  int a = 0;
  for (; a + 3 < n; a += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) add3(acc[k], attraction(u, a + k, p, dt));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (a + k < n) add3(acc[k], attraction(u, a + k, p, dt));
  add3(acc[0], acc[1]);
  add3(acc[0], acc[2]);
  add3(acc[0], acc[3]);
  return acc[0];
}

// apply_gravity: the attractors' sum clamped to maximum_acceleration * dt,
// added to v.xyz and held under the maximum velocity, on live slots in the
// filter.
__device__ __forceinline__ void gravity_step(const Uniforms& u, int n,
                                             float dt, float max_velocity,
                                             float4 p, float4& v) {
  float3 acc = attractor_sum(u, n, p, dt);
  const float max_accel = u.f(kGravityMaximum) * dt;
  const float alen = sqrtf(tmax(sum3(acc.x * acc.x, acc.y * acc.y,
                                     acc.z * acc.z), 1e-12f));
  const float k = tmin(max_accel / alen, 1.0f);
  if (!(p.w > 0.0f && in_filter(u, kGravityCategory, v.w))) return;
  v = make_float4(tmin(v.x + acc.x * k, max_velocity),
                  tmin(v.y + acc.y * k, max_velocity),
                  tmin(v.z + acc.z * k, max_velocity), v.w);
}

// apply_vector_field: the field bilinear at p.xy, times velocity_scale,
// steers v on live slots in the filter.
__device__ __forceinline__ void field_step(const Uniforms& u, const Step& st,
                                           float dt, float4 p, float4& v) {
  const float w = area_weight(u, p);
  const float t = time_weight(w, u.f(kFieldCycles), dt);
  const float4 s = bilinear_sample(st, p.x, p.y, u.f(kFieldOffset, 0),
                                   u.f(kFieldOffset, 1), u.f(kFieldScale, 0),
                                   u.f(kFieldScale, 1));
  const float4 vs = u.f4(kFieldVelocityScale);
  const float4 d = make_float4(s.x * vs.x, s.y * vs.y, s.z * vs.z,
                               s.w * vs.w);
  if (!(p.w > 0.0f && in_filter(u, kFieldCategory, v.w))) return;
  v = steer(v, d, w, t, u.f(kFieldReplace));
}

// One noise draw (_noise_draws): the field at the current and the next
// randomness offset, lerped by frequency_lerp; point samples at the slot's
// texel (temporal) or bilinear at the position (spatial).
__device__ __forceinline__ float4 noise_draw(const Uniforms& u,
                                             const Step& st, bool spatial,
                                             float x, float y) {
  float4 a, b;
  if (spatial) {
    const float rx = u.f(kNoiseSpaceScale, 0), ry = u.f(kNoiseSpaceScale, 1);
    a = bilinear_sample(st, x, y, u.f(kNoiseOffset, 0), u.f(kNoiseOffset, 1),
                        rx, ry);
    b = bilinear_sample(st, x, y, u.f(kNoiseNextOffset, 0),
                        u.f(kNoiseNextOffset, 1), rx, ry);
  } else {
    a = point_sample(st, x, y, u.f(kNoiseOffset, 0), u.f(kNoiseOffset, 1));
    b = point_sample(st, x, y, u.f(kNoiseNextOffset, 0),
                     u.f(kNoiseNextOffset, 1));
  }
  return lerp4(a, b, u.f(kNoiseLerp));
}

// (draw + offset), through sign(d) * max(|d|, minimum) for temporal noise
// (PS_Noise only), times scale.
__device__ __forceinline__ float4 noise_delta(float4 r, float4 offset,
                                              float4 minimum, float4 scale,
                                              bool with_minimum) {
  float d[4] = {r.x + offset.x, r.y + offset.y, r.z + offset.z,
                r.w + offset.w};
  const float m[4] = {minimum.x, minimum.y, minimum.z, minimum.w};
  const float s[4] = {scale.x, scale.y, scale.z, scale.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (with_minimum) d[c] = sgn(d[c]) * tmax(fabsf(d[c]), m[c]);
    d[c] = d[c] * s[c];
  }
  return make_float4(d[0], d[1], d[2], d[3]);
}

// apply_noise / apply_spatial_noise (_noise_core): gated by the category
// filter only (Noise.fx applies regardless of life). The temporal draw's
// texel is the slot's (transforms.slot_xy: i % 256, floor(i / 256) of the
// float32 index).
__device__ __forceinline__ void noise_step(const Uniforms& u, const Step& st,
                                           bool spatial, long long i,
                                           float dt, float4& p, float4& v) {
  float x, y;
  if (spatial) {
    x = p.x;
    y = p.y;
  } else {
    const float fi = (float)i;
    x = torch_remainder(fi, 256.0f);
    y = floorf(fi / 256.0f);
  }
  const float4 rp = noise_draw(u, st, spatial, x, y);
  const float4 rv = noise_draw(u, st, spatial, x + 2.0f, y + 1.0f);
  const float w = area_weight(u, p);
  const float t = time_weight(w, u.f(kNoiseCycles), dt);
  const float4 pd = noise_delta(rp, u.f4(kNoisePositionOffset),
                                u.f4(kNoisePositionMinimum),
                                u.f4(kNoisePositionScale), !spatial);
  const float4 vd = noise_delta(rv, u.f4(kNoiseVelocityOffset),
                                u.f4(kNoiseVelocityMinimum),
                                u.f4(kNoiseVelocityScale), !spatial);
  if (!in_filter(u, kNoiseCategory, v.w)) return;
  v = steer(v, vd, w, t, u.f(kNoiseReplace));
  p = make_float4(p.x + pd.x * t, p.y + pd.y * t, p.z + pd.z * t,
                  p.w + pd.w * t);
}

__global__ void __launch_bounds__(kThreads)
    modifiers_kernel(const Launch L, const Program P) {
  // The program's offsets and steps are copied too: a step reads its
  // segments through a pointer, which must not point into the parameters.
  __shared__ unsigned words[kMaxWords];
  __shared__ int offset[kMaxSegments + 1];
  __shared__ Step steps[kMaxSteps];
  for (int s = threadIdx.x; s <= P.segments; s += kThreads) {
    offset[s] = P.offset[s];
    if (s < P.steps) steps[s] = P.step[s];
    if (s == P.segments) continue;
    const unsigned* src = P.ptr[s];
    for (int k = P.offset[s]; k < P.offset[s + 1]; ++k)
      words[k] = __ldg(src + (k - P.offset[s]));
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L.n) return;
  // SystemUniforms.global_settings: dt, friction, maximum_velocity, ...
  const float dt = __uint_as_float(words[offset[0]]);
  const float max_velocity = __uint_as_float(words[offset[0] + 2]);
  float4 p = __ldg(L.position + i), v = __ldg(L.velocity + i);
  for (int s = 0; s < P.steps; ++s) {
    const Step& st = steps[s];
    const Uniforms u{words, offset + st.first};
    switch (st.kind) {
      case kFMA: fma_step(u, dt, p, v); break;
      case kMatrixMultiply: matrix_step(u, dt, p, v); break;
      case kGravity: gravity_step(u, st.attractors, dt, max_velocity, p, v);
        break;
      case kVectorField: field_step(u, st, dt, p, v); break;
      case kNoise: noise_step(u, st, false, i, dt, p, v); break;
      case kSpatialNoise: noise_step(u, st, true, i, dt, p, v); break;
      default: break;
    }
  }
  L.out_position[i] = p;
  L.out_velocity[i] = v;
}

// Each kind's segment count.
__host__ int kind_segments(int kind) {
  switch (kind) {
    case kFMA: return kFMASegments;
    case kMatrixMultiply: return kMatrixSegments;
    case kGravity: return kGravitySegments;
    case kVectorField: return kFieldSegments;
    default: return kNoiseSegments;
  }
}

}  // namespace

// ptrs: position, velocity, out_position, out_velocity, then each step's
// field (or null), then each segment's tensor (segment 0 the system's
// global settings, then each step's in order). ints: slots, steps,
// segments, then each step's (kind, first segment, attractors, field
// height, field width), then each segment's first word in the block's
// copy and the copy's end.
extern "C" int k4c_modifiers(const void* const* ptrs, const long long* ints,
                             void* stream) {
  Launch L;
  L.position = (const float4*)ptrs[0];
  L.velocity = (const float4*)ptrs[1];
  L.out_position = (float4*)ptrs[2];
  L.out_velocity = (float4*)ptrs[3];
  L.n = ints[0];
  Program P;
  P.steps = (int)ints[1];
  P.segments = (int)ints[2];
  if (L.n < 0 || L.n >= (1LL << 31) || P.steps < 0 || P.steps > kMaxSteps ||
      P.segments < 1 || P.segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  const long long* step_ints = ints + 3;
  for (int s = 0; s < P.steps; ++s) {
    Step& st = P.step[s];
    st.kind = (int)step_ints[5 * s];
    st.first = (int)step_ints[5 * s + 1];
    st.attractors = (int)step_ints[5 * s + 2];
    st.height = (int)step_ints[5 * s + 3];
    st.width = (int)step_ints[5 * s + 4];
    st.field = (const float4*)ptrs[4 + s];
    if (st.kind < 0 || st.kind >= kKinds || st.first < 1 ||
        st.first + kind_segments(st.kind) > P.segments)
      return (int)cudaErrorInvalidValue;
    if (st.kind == kGravity &&
        (st.attractors < 1 || st.attractors > kMaxAttractors))
      return (int)cudaErrorInvalidValue;
    const bool sampled = st.kind == kVectorField || st.kind == kNoise ||
                         st.kind == kSpatialNoise;
    if (sampled && (!st.field || st.height < 1 || st.width < 1))
      return (int)cudaErrorInvalidValue;
  }
  const long long* offsets = step_ints + 5 * P.steps;
  for (int s = 0; s <= P.segments; ++s) {
    P.offset[s] = (int)offsets[s];
    if (s < P.segments) P.ptr[s] = (const unsigned*)ptrs[4 + P.steps + s];
    if (s > 0 && (P.offset[s] < P.offset[s - 1] || !P.ptr[s - 1]))
      return (int)cudaErrorInvalidValue;
  }
  if (P.offset[0] != 0 || P.offset[P.segments] > kMaxWords ||
      P.offset[1] - P.offset[0] < 4)
    return (int)cudaErrorInvalidValue;
  if (L.n == 0) return 0;
  const long long blocks = (L.n + kThreads - 1) / kThreads;
  modifiers_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      L, P);
  return (int)cudaGetLastError();
}

extern "C" int k4c_modifiers_plan(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, modifiers_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                      modifiers_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = blocks;
  out[4] = (int)attr.sharedSizeBytes;
  return 0;
}
