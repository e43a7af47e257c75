// K4: the particles' SDF collision integrate and render data for Hopper
// (sm_90a).
//
// Replaces the eager body of particles/integrate.py:
// integrate_with_distance_field (UpdateParticleSystemWithDistanceField.fx)
// with render_data.compute_render_data on the card: ~270 lines of planar
// PyTorch, about a thousand small kernels a call, each one pass over the
// 1M slots, launched by the host one at a time (the JAX package's
// counterpart, illuminant_tpu/particles/integrate.py, is one XLA fusion).
//
// One thread a slot. It reads the slot's position, velocity and colour
// rows (3 x 16 B) and writes its new position, velocity, render colour and
// render data (4 x 16 B): 112 B a slot, all else in registers, so what
// bounds it on an H100 is bytes. In order, as the eager body: friction and
// the maximum velocity, life decay, the initial distance, up to kSubsteps
// sphere-trace steps with backtracking, the collision normal at the
// collision point (only where the outcome reads it), the bounce / escape /
// redirect outcomes (the redirect's fallback the uint32 Weyl hash of the
// ring slot), then the colour and size beziers, the optional life-ramp
// texel and the rotation of the render data, from registers. A dead slot
// keeps its rows and takes zero render data, as the eager `sel` gives it.
//
// The field is sampled by the device functions of sdf_fields.cuh:
//   * an AnalyticScene within the unroll limit (64 live primitives) and
//     without polygons: its type groups' centers, sizes and rotations are
//     staged in shared memory once a block as the records K12 reads
//     (cone_trace_kernel.analytic_records' order; no host-side pack, so
//     no launch); the normal is `analytic_normal_fast`, the nearest
//     primitive's closed form;
//   * any other AnalyticScene (above the unroll limit, or with polygons):
//     K12's records (analytic_records, the pad slots too above the limit)
//     and polygons, read from device memory; the normal is
//     sdf_gradients.cuh's, the central differences of the batched
//     distance without polygons, the autograd gradient with them;
//   * a ColumnField: column_query.cuh's distance, and
//     `column_distance_grad`'s unit gradient for the normal, on the field's
//     quad pack (columns_kernel.packed: one pack launch a new set of
//     maps): the tick launches no column query.
// The uniforms (SystemUniforms, the render data's beziers and rotation,
// the life ramp's settings) are device tensors; a block copies them into
// shared memory once, so the launch reads nothing on the host.
//
// Instances: the field kind x kSubsteps (0-3), a template parameter, so
// the substep loop unrolls, or -1 for a count above 3 given at run time;
// maximum_z and the first ring slot are runtime arguments.
//
// Rounding: the file is compiled with -fmad=false, division and sqrtf are
// IEEE, sinf / atan2f / fmodf are CUDA's precise forms (those torch's
// card kernels call), and every formula keeps the eager operation order,
// the card's order of torch.sum over a 3-wide axis included, so the kernel
// equals the eager body run on the card bit for bit
// (tests/test_torch_integrate_cuda.py) on a staged scene and a
// ColumnField. On a scene read from device memory it is bounded, and the
// slots that differ are counted: above the unroll limit the batched
// distance (K12's device function) adds each 3-wide length in order where
// torch's `_length` on the card does not, and the central-difference
// normal carries that rounding ten times over into the bounce; the
// autograd gradient's sums round in another order than the backward
// pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bezier.cuh"
#include "sdf_fields.cuh"
#include "sdf_gradients.cuh"

namespace {

using namespace illum_bezier;
using namespace illum_fields;

constexpr int kThreads = 256;
// Primitives and type groups of a staged scene (AnalyticScene's unroll
// limit; it groups by type: 5 groups).
constexpr int kMaxPrimitives = 64;
constexpr int kMaxGroups = 8;

// UpdateParticleSystemWithDistanceField.fx:12-25.
constexpr float kBounceDelay = 3.0f;
constexpr float kNoNormalThreshold = 0.33f;
constexpr float kInitialEscapeSpeed = 0.33f;
constexpr float kEscapeSpeedAcceleration = 1.1f;

// The field kinds; an instance is kind * kVariants + the substeps
// variant (0-3, kRuntimeSubsteps above 3).
enum Kind {
  kAnalytic = 0,        // AnalyticScene, its groups staged in shared memory
  kColumn = 1,          // ColumnField
  kAnalyticGlobal = 2,  // AnalyticScene, K12's records in device memory
  kKinds
};
constexpr int kRuntimeSubsteps = 4;
constexpr int kVariants = 5;

// The uniform table: segments in this order, each copied to its fixed
// offset of the block's copy (integrate_kernel.UNIFORM_SEGMENTS).
enum Segment {
  kGlobal = 0,       // dt, friction, maximum_velocity, life_decay
  kCollision,        // escape, bounce multiplier, distance, life penalty
  kColorLifeHead,    // each bezier: (min, inv_divisor, count, mode)
  kColorLifePoints,  // and its (4, C) control points
  kColorVelHead,
  kColorVelPoints,
  kSizeLifeHead,
  kSizeLifePoints,
  kSizeVelHead,
  kSizeVelPoints,
  kRotation,          // rotation_from_life_and_index
  kVelocityRotation,  // velocity_rotation
  kRampSettings,      // life_ramp_settings
  kSegments
};
__constant__ const int kSegmentCapacity[kSegments] = {4, 4, 4, 16, 4, 16, 4,
                                                      16, 4, 16, 2, 1, 4};
__constant__ const int kSegmentOffset[kSegments] = {
    0, 4, 8, 12, 28, 32, 48, 52, 68, 72, 88, 90, 91};
constexpr int kUniformFloats = 96;

struct Particles {
  const float4* position;
  const float4* velocity;
  const float4* color;
  float4* out_position;
  float4* out_velocity;
  float4* out_render_color;
  float4* out_render_data;
  long long n;
  long long first_slot;
  float maximum_z;
  int substeps;  // the count of the run-time instance
};

struct Uniforms {
  const float* ptr[kSegments];  // null: absent, reads 0
  int len[kSegments];
};

struct Render {
  int channels[4];  // control-point channels of the four beziers
  int constant[4];  // 1: a constant bezier (its first point)
  int velocity_rotation;
  const float* ramp;  // (ramp_h, ramp_w, 4), or null
  int ramp_h, ramp_w;
};

struct Group {
  const float* centers;    // (count, 3)
  const float* sizes;      // (count, 3)
  const float* rotations;  // (count, 4)
  int count, type, rotated;
};

struct Fields {
  Analytic analytic;  // count and maximum distance; records staged
  Group groups[kMaxGroups];
  int n_groups;
  Column column;
};

// The block's copy of the uniform table.
__device__ __forceinline__ void stage_uniforms(const Uniforms& t,
                                               float* u) {
  for (int j = threadIdx.x; j < kUniformFloats; j += kThreads) {
    float v = 0.0f;
#pragma unroll
    for (int s = 0; s < kSegments; ++s) {
      const int k = j - kSegmentOffset[s];
      if (k >= 0 && k < kSegmentCapacity[s] && k < t.len[s] && t.ptr[s])
        v = __ldg(t.ptr[s] + k);
    }
    u[j] = v;
  }
}

// The scene's records built in shared memory from its groups, in
// analytic_records' order: type, rotated, center xyz, size xyz,
// quaternion xyzw a primitive.
__device__ __forceinline__ void stage_groups(const Fields& f, float* sm) {
  const int total = f.analytic.count * kPrimitiveRecord;
  for (int j = threadIdx.x; j < total; j += kThreads) {
    int p = j / kPrimitiveRecord;
    const int k = j - p * kPrimitiveRecord;
    int g = 0;
    while (g + 1 < f.n_groups && p >= f.groups[g].count) {
      p -= f.groups[g].count;
      ++g;
    }
    const Group& gr = f.groups[g];
    float v;
    if (k == 0)
      v = (float)gr.type;
    else if (k == 1)
      v = gr.rotated ? 1.0f : 0.0f;
    else if (k < 5)
      v = __ldg(gr.centers + 3 * p + (k - 2));
    else if (k < 8)
      v = __ldg(gr.sizes + 3 * p + (k - 5));
    else
      v = __ldg(gr.rotations + 4 * p + (k - 8));
    sm[j] = v;
  }
}

template <int F>
__device__ __forceinline__ float field_distance(const Analytic& s,
                                                const Column& c, float x,
                                                float y, float z) {
  if (F == kAnalytic) return analytic_distance<true>(s, x, y, z);
  if (F == kAnalyticGlobal) return analytic_distance<false>(s, x, y, z);
  return column_distance(c, x, y, z);
}

// The collision normal: scene_normal_p(fast=True), which on a ColumnField
// is the fused query's unit gradient (the one the eager body takes from
// its step sample at one substep: there the collision point is that
// step's position).
template <int F>
__device__ __forceinline__ void field_normal(const Analytic& s,
                                             const Column& c, float x,
                                             float y, float z, float* nx,
                                             float* ny, float* nz) {
  if (F == kAnalytic) {
    analytic_normal_fast<true>(s, x, y, z, nx, ny, nz);
  } else if (F == kAnalyticGlobal) {
    if (s.polygons.count > 0)
      analytic_normal_autograd<false>(s, x, y, z, nx, ny, nz);
    else
      analytic_normal_central<false>(s, x, y, z, nx, ny, nz);
  } else {
    illum_columns::column_distance_grad(c.pack, c.hc, c.wc, c.g, x, y, z,
                                        true, nx, ny, nz);
  }
}

// Bezier `which` (0 colour from life, 1 colour from velocity, 2 size from
// life, 3 size from velocity) at `value`: its `n` first channels.
template <int N>
__device__ __forceinline__ void bezier(const float* u, const Render& r,
                                       int which, float value,
                                       float (&out)[N]) {
  const float* head = u + kSegmentOffset[kColorLifeHead + 2 * which];
  const float* points = u + kSegmentOffset[kColorLifePoints + 2 * which];
  const int channels = r.channels[which];
  if (r.constant[which]) {
#pragma unroll
    for (int c = 0; c < N; ++c) out[c] = points[channels == 1 ? 0 : c];
    return;
  }
  float count;
  const float t = bezier_t(head, value, &count);
#pragma unroll
  for (int c = 0; c < N; ++c)
    out[c] = bezier_channel(points, channels, count, t, c);
}

// The render data (render_data.compute_render_data) of a slot's new rows.
__device__ __forceinline__ void render_data(const float* u, const Render& r,
                                            float4 p, float4 v, float4 attr,
                                            int index, float4* rc_out,
                                            float4* rd_out) {
  const float life = p.w;
  if (life <= 0.0f) {
    *rc_out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *rd_out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  // torch.sum over the 3-wide last axis adds (x^2 + z^2) + y^2 on the
  // card (the CPU adds (x^2 + y^2) + z^2).
  const float vel_len = fmaxf(sqrtf(v.x * v.x + v.z * v.z + v.y * v.y),
                              1e-4f);
  float cl[4], cv[4], color[4];
  bezier<4>(u, r, 0, life, cl);
  bezier<4>(u, r, 1, vel_len, cv);
#pragma unroll
  for (int c = 0; c < 4; ++c) color[c] = cl[c] * cv[c];
  const float findex = (float)index;
  if (r.ramp != nullptr) {
    // getRampedColorForLifeValueAndIndex (render_data._life_ramp).
    const float* s = u + kSegmentOffset[kRampSettings];
    const float strength = s[0];
    float uu = (life - s[1]) / s[2];
    if (strength < 0.0f) uu = 1.0f - fminf(fmaxf(uu, 0.0f), 1.0f);
    long long col = (long long)floorf(uu * (float)r.ramp_w);
    col = col < 0 ? 0 : (col > r.ramp_w - 1 ? r.ramp_w - 1 : col);
    long long row =
        (long long)floorf(findex / s[3] * (float)r.ramp_h) % r.ramp_h;
    if (row < 0) row += r.ramp_h;
    const float4 texel = __ldg(
        reinterpret_cast<const float4*>(r.ramp) + (row * r.ramp_w + col));
    const float tex[4] = {texel.x, texel.y, texel.z, texel.w};
    const float blend = fminf(fmaxf(fabsf(strength), 0.0f), 1.0f);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      color[c] = color[c] + (tex[c] * color[c] - color[c]) * blend;
  }
  const float rcx = attr.x * color[0], rcy = attr.y * color[1],
              rcz = attr.z * color[2], rcw = attr.w * color[3];
  const float a = fminf(fmaxf(rcw, 0.0f), 1.0f);
  *rc_out = make_float4(rcx * a, rcy * a, rcz * a, a);

  float sl[1], sv[1];
  bezier<1>(u, r, 2, life, sl);
  bezier<1>(u, r, 3, vel_len, sv);
  const float* rot = u + kSegmentOffset[kRotation];
  float rotation = life * rot[0] + findex * rot[1];
  if (r.velocity_rotation) {
    // getRotationForVelocity (render_data.rotation_for_velocity).
    float angle = atan2f(v.y, v.x);
    angle = angle < 0.0f ? angle + 6.28318548f : angle;  // float32(2 pi)
    const bool near_zero = fabsf(v.x) < 0.01f && fabsf(v.y) < 0.01f;
    rotation = rotation + (near_zero ? 0.0f : angle) *
                              u[kSegmentOffset[kVelocityRotation]];
  }
  *rd_out = make_float4(sl[0] * sv[0], rotation, vel_len, v.w);
}

template <int F, int kSubsteps>
__global__ void __launch_bounds__(kThreads)
    collide_integrate_kernel(Particles p, Uniforms t, Render r, Fields f) {
  extern __shared__ float4 smem4[];
  __shared__ float u[kUniformFloats];
  stage_uniforms(t, u);
  Analytic scene = f.analytic;
  if (F == kAnalytic) {
    stage_groups(f, (float*)smem4);
    scene.records = (const float*)smem4;
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;

  const float4 pos = __ldg(p.position + i);
  const float4 vel = __ldg(p.velocity + i);
  const float4 attr = __ldg(p.color + i);
  const long long slot = p.first_slot + i;
  float4 out_p = pos, out_v = vel;  // a dead slot keeps its rows

  const float dt = u[kSegmentOffset[kGlobal] + 0];
  const float friction = u[kSegmentOffset[kGlobal] + 1];
  const float max_v = u[kSegmentOffset[kGlobal] + 2];
  const float life_decay = u[kSegmentOffset[kGlobal] + 3];
  const float escape_velocity = u[kSegmentOffset[kCollision] + 0];
  const float bounce_mult = u[kSegmentOffset[kCollision] + 1];
  const float collision_distance = u[kSegmentOffset[kCollision] + 2];
  const float life_penalty = u[kSegmentOffset[kCollision] + 3];

  const bool was_alive = pos.w > 0.0f;
  if (was_alive) {
    const float ox = pos.x, oy = pos.y, oz = pos.z;
    float new_life = pos.w - life_decay * dt;
    const bool alive = new_life > 0.0f;

    // Friction and maximum velocity (_friction_max_p with the length).
    const float v0len =
        sqrtf(vel.x * vel.x + vel.y * vel.y + vel.z * vel.z + 1e-12f);
    const float ux = vel.x / v0len, uy = vel.y / v0len, uz = vel.z / v0len;
    const float clamped = fminf(v0len, max_v);
    const float fric = clamped * friction;
    const float new_l =
        fminf(fmaxf(clamped - fric * dt, 0.0f), max_v);
    const bool small = v0len <= 0.001f;
    const float m = small ? 0.0f : new_l / v0len;
    const float vx = vel.x * m, vy = vel.y * m, vz = vel.z * m;
    const float v_new_len = small ? 0.0f : new_l;
    const float scaled_len = v_new_len * dt;

    // fx:63-90: the initial distance, then the substeps.
    const bool above_field = oz > p.maximum_z;
    const float initial_distance =
        above_field ? 1e9f : field_distance<F>(scene, f.column, ox, oy, oz);
    const bool was_colliding = initial_distance < collision_distance;
    float travel = fmaxf(fminf(initial_distance, scaled_len), 0.0f);
    bool collided = false, escaping = false;
    float cpx = 0.0f, cpy = 0.0f, cpz = 0.0f;
    const int substeps = kSubsteps >= 0 ? kSubsteps : p.substeps;
    int steps_left = was_colliding ? 1 : (travel <= 0.001f ? 0 : substeps);
#pragma unroll
    for (int s = 0; s < substeps; ++s) {
      // An inactive slot's step changes nothing it keeps.
      if (steps_left <= 0) break;
      const float tx = ox + travel * ux;
      const float ty = oy + travel * uy;
      const float tz = oz + travel * uz;
      const float step_distance =
          above_field ? 1e9f : field_distance<F>(scene, f.column, tx, ty, tz);
      const bool newly = step_distance < collision_distance;
      collided = collided || newly;
      escaping = step_distance > initial_distance;
      const bool backtrack = collided && !escaping;
      if (newly || backtrack) {
        cpx = tx;
        cpy = ty;
        cpz = tz;
      }
      const float offset =
          fminf(fmaxf(step_distance + collision_distance, 0.05f), 16.0f);
      if (backtrack) travel = fmaxf(travel - offset, 0.0f);
      steps_left = (backtrack && travel > 0.001f) ? steps_left - 1 : 0;
    }

    // fx:92-139: the outcomes.
    const bool bounce = vel.w <= 0.0f;
    const bool redirect = was_colliding && !escaping;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (collided && (bounce || redirect))
      field_normal<F>(scene, f.column, cpx, cpy, cpz, &nx, &ny, &nz);
    const float escape_speed = fminf(max_v, escape_velocity);

    // Redirect: along the xy-masked normal, or the slot-hash direction
    // where the normal is too short (fx:103-116).
    const float zero = 0.0f;
    const float r_len = sqrtf(nx * nx + ny * ny + zero * zero + 1e-12f);
    const uint32_t s32 = (uint32_t)slot;
    const uint32_t h1 = s32 * 2654435761u;
    const uint32_t h2 = (s32 + 0x9E3779B9u) * 2246822519u;
    const float fbx0 = (float)(h1 >> 16) / 32768.0f - 1.0f;
    const float fby0 = (float)(h2 >> 16) / 32768.0f - 1.0f;
    const float fb_len =
        sqrtf(fbx0 * fbx0 + fby0 * fby0 + zero * zero + 1e-6f);
    const float fbx = fbx0 / fb_len, fby = fby0 / fb_len;
    const bool no_norm = r_len < kNoNormalThreshold;
    const float rdx = no_norm ? fbx : nx;
    const float rdy = no_norm ? fby : ny;
    const float rd_len = no_norm ? 1.0f : fmaxf(r_len, 1e-6f);
    const float r_speed = escape_speed * kInitialEscapeSpeed;
    const float r_vx = rdx / rd_len * r_speed;
    const float r_vy = rdy / rd_len * r_speed;
    const float r_vz = zero;

    // Bounce: reflect (fx:117-128).
    const float ndotu = nx * ux + ny * uy + nz * uz;
    const float bvx = -(2.0f * ndotu * (nx - ux));
    const float bvy = -(2.0f * ndotu * (ny - uy));
    const float bvz = -(2.0f * ndotu * (nz - uz));
    const float b_len = sqrtf(bvx * bvx + bvy * bvy + bvz * bvz + 1e-12f);
    const bool short_ = b_len < kNoNormalThreshold;
    const float b_speed = fminf(max_v, v_new_len * bounce_mult);

    // Escaping while colliding: accelerate out (fx:129-135).
    const float e_speed =
        fmaxf(v0len * kEscapeSpeedAcceleration, escape_speed);

    const bool sel_redirect = collided && redirect;
    const bool sel_bounce = collided && !redirect && bounce;
    const bool sel_escape = collided && !redirect && !bounce;
    float o_vx, o_vy, o_vz, o_px, o_py, o_pz;
    if (sel_redirect) {
      o_vx = r_vx;
      o_vy = r_vy;
      o_vz = r_vz;
      o_px = ox + r_vx * dt;
      o_py = oy + r_vy * dt;
      o_pz = oz + r_vz * dt;
    } else if (sel_bounce) {
      o_vx = (short_ ? -ux : bvx / b_len) * b_speed;
      o_vy = (short_ ? -uy : bvy / b_len) * b_speed;
      o_vz = (short_ ? -uz : bvz / b_len) * b_speed;
      o_px = cpx;
      o_py = cpy;
      o_pz = cpz;
    } else {
      if (sel_escape) {
        o_vx = ux * e_speed;
        o_vy = uy * e_speed;
        o_vz = uz * e_speed;
      } else {  // no collision (fx:136-139)
        o_vx = vx;
        o_vy = vy;
        o_vz = vz;
      }
      o_px = ox + travel * ux;
      o_py = oy + travel * uy;
      o_pz = oz + travel * uz;
    }
    const float o_w = (collided && (redirect || bounce))
                          ? kBounceDelay
                          : (collided ? vel.w : fmaxf(vel.w - 1.0f, 0.0f));
    if (sel_bounce) new_life = new_life - life_penalty;

    const bool keep = alive && new_life > 0.0f;
    out_p = keep ? make_float4(o_px, o_py, o_pz, new_life)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    out_v = keep ? make_float4(o_vx, o_vy, o_vz, o_w)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float4 rc, rd;
  render_data(u, r, out_p, out_v, attr, (int)slot, &rc, &rd);
  p.out_position[i] = out_p;
  p.out_velocity[i] = out_v;
  p.out_render_color[i] = rc;
  p.out_render_data[i] = rd;
}

template <int F>
const void* instance_fn_of(int variant) {
  switch (variant) {
    case 0:
      return (const void*)collide_integrate_kernel<F, 0>;
    case 1:
      return (const void*)collide_integrate_kernel<F, 1>;
    case 2:
      return (const void*)collide_integrate_kernel<F, 2>;
    case 3:
      return (const void*)collide_integrate_kernel<F, 3>;
    case kRuntimeSubsteps:
      return (const void*)collide_integrate_kernel<F, -1>;
    default:
      return nullptr;
  }
}

const void* instance_fn(int instance) {
  const int kind = instance / kVariants, variant = instance % kVariants;
  if (instance < 0) return nullptr;
  switch (kind) {
    case kAnalytic:
      return instance_fn_of<kAnalytic>(variant);
    case kColumn:
      return instance_fn_of<kColumn>(variant);
    case kAnalyticGlobal:
      return instance_fn_of<kAnalyticGlobal>(variant);
    default:
      return nullptr;
  }
}

}  // namespace

// ptrs: position, velocity, color, out position, out velocity, out render
//       color, out render data (each (n, 4) float32, 16-byte aligned),
//       the kSegments uniform tensors (null: absent), the life ramp
//       (ramp_h, ramp_w, 4) (null: none), then the field's: per group
//       centers, sizes, rotations, kMaxGroups groups (kAnalytic) | the
//       5-map quad pack (kColumn) | the (count, kPrimitiveRecord)
//       records, the polygons' vertices, next vertices, z range and
//       active flags (null without polygons) (kAnalyticGlobal).
// ints: n, first_slot, substeps, the kSegments uniform lengths, the four
//       beziers' channels, their constant flags, velocity rotation
//       (0 / 1), ramp_h, ramp_w, then the field's: count, groups, then
//       per group count, type, rotated (kMaxGroups groups) | hc, wc |
//       count, batched, polygons, edges.
// floats: maximum_z, then the field's: maximum_distance | the 12 column
//       geometry | maximum_distance.
// `instance`: field kind * kVariants + the substeps variant.
extern "C" int collide_integrate(const void* const* ptrs,
                                 const long long* ints, const float* floats,
                                 int instance, void* stream) {
  const void* fn = instance_fn(instance);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  Particles p;
  p.position = (const float4*)ptrs[0];
  p.velocity = (const float4*)ptrs[1];
  p.color = (const float4*)ptrs[2];
  p.out_position = (float4*)ptrs[3];
  p.out_velocity = (float4*)ptrs[4];
  p.out_render_color = (float4*)ptrs[5];
  p.out_render_data = (float4*)ptrs[6];
  p.n = ints[0];
  p.first_slot = ints[1];
  p.substeps = (int)ints[2];
  p.maximum_z = floats[0];
  Uniforms t;
  for (int s = 0; s < kSegments; ++s) {
    t.ptr[s] = (const float*)ptrs[7 + s];
    t.len[s] = (int)ints[3 + s];
  }
  const long long* ri = ints + 3 + kSegments;
  Render r;
  for (int b = 0; b < 4; ++b) {
    r.channels[b] = (int)ri[b];
    r.constant[b] = (int)ri[4 + b];
    if (r.channels[b] < 1 || (b < 2 && r.channels[b] != 1 &&
                              r.channels[b] != 4))
      return (int)cudaErrorInvalidValue;
  }
  r.velocity_rotation = (int)ri[8];
  r.ramp = (const float*)ptrs[7 + kSegments];
  r.ramp_h = (int)ri[9];
  r.ramp_w = (int)ri[10];
  if (r.ramp != nullptr && (r.ramp_h < 1 || r.ramp_w < 1))
    return (int)cudaErrorInvalidValue;
  const long long* fi = ri + 11;
  const float* ff = floats + 1;
  const void* const* fp = ptrs + 8 + kSegments;

  Fields f = {};
  const int kind = instance / kVariants;
  size_t smem = 0;
  if (kind == kAnalytic) {
    f.analytic.count = (int)fi[0];
    f.analytic.maximum_distance = ff[0];
    f.n_groups = (int)fi[1];
    if (f.analytic.count > kMaxPrimitives || f.n_groups < 0 ||
        f.n_groups > kMaxGroups)
      return (int)cudaErrorInvalidValue;
    int total = 0;
    for (int g = 0; g < f.n_groups; ++g) {
      f.groups[g].centers = (const float*)fp[3 * g];
      f.groups[g].sizes = (const float*)fp[3 * g + 1];
      f.groups[g].rotations = (const float*)fp[3 * g + 2];
      f.groups[g].count = (int)fi[2 + 3 * g];
      f.groups[g].type = (int)fi[3 + 3 * g];
      f.groups[g].rotated = (int)fi[4 + 3 * g];
      total += f.groups[g].count;
    }
    if (total != f.analytic.count) return (int)cudaErrorInvalidValue;
    smem = sizeof(float) * (size_t)total * kPrimitiveRecord;
  } else if (kind == kAnalyticGlobal) {
    Analytic& a = f.analytic;
    a.records = (const float*)fp[0];
    a.count = (int)fi[0];
    a.batched = (int)fi[1];
    a.polygons.count = (int)fi[2];
    a.polygons.edges = (int)fi[3];
    a.polygons.vertices = (const float*)fp[1];
    a.polygons.next_vertices = (const float*)fp[2];
    a.polygons.z_range = (const float*)fp[3];
    a.polygons.active = (const float*)fp[4];
    a.maximum_distance = ff[0];
    if (a.count < 0 || (a.count > 0 && a.records == nullptr) ||
        a.polygons.count < 0 ||
        (a.polygons.count > 0 &&
         (a.polygons.edges < 1 || a.polygons.vertices == nullptr ||
          a.polygons.next_vertices == nullptr ||
          a.polygons.z_range == nullptr || a.polygons.active == nullptr)))
      return (int)cudaErrorInvalidValue;
  } else {
    f.column.pack = (const float*)fp[0];
    f.column.hc = (int)fi[0];
    f.column.wc = (int)fi[1];
    f.column.g = illum_columns::geometry_from(ff);
  }
  if (p.n <= 0) return 0;
  const unsigned int blocks =
      (unsigned int)((p.n + kThreads - 1) / kThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  void* args[] = {&p, &t, &r, &f};
  return (int)cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args, smem,
                               st);
}

// The block of kernel instance `instance` with `smem` bytes of dynamic
// shared memory: threads, registers and spilled bytes a thread, resident
// blocks an SM.
extern "C" int collide_integrate_plan(int instance, int smem, int* out) {
  const void* fn = instance_fn(instance);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = blocks;
  return 0;
}
