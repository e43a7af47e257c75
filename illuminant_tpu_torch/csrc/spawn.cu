// K4b: the particles' spawn for Hopper (sm_90a).
//
// Replaces the eager body of particles/spawner.py:spawn (Spawn_Stage1/2,
// SpawnerCommon.fxh:119-190) on the card, and with it the eager
// evaluation of the spawn's animated uniforms (ops/bezier.py: the
// flagship's emission path and its velocity post-matrix, a Spawner's
// animated Parameter<DynamicMatrix>): about 800 small kernels a flagship
// frame, each on a few scalars or 4,096 x 4 floats, launched by the host
// one at a time (the JAX package's counterpart,
// illuminant_tpu/particles/spawner.py, is one XLA fusion).
//
// One thread a ring slot that the window writes (4,096 rows into a larger
// ring: 16 blocks of 256), so the launch is bound by latency, not bytes
// (~400 kB moved). A block first copies the uniform table (the
// SpawnUniforms tensors and the animations' headers and controls, read
// where they lie) into shared memory, one thread a segment, each to the
// offset the host lays out (spawn_kernel.UNIFORM_SEGMENTS); its thread 0
// then evaluates the animated uniforms at the time read from the device
// (the emission path replaces the xyz of every position constant, a
// BezierM replaces its static post-matrix), each wrapped by its period as
// torch.remainder wraps it. Each thread then follows the eager body: its
// slot (`sub_rings` segments with one shared local cursor, a mesh rank's
// `shard` of the ring), the position-constant cycle or the polygon walk
// (loop or clamp, pattern colours), the position, velocity and attribute
// formulas, both post-matrices, the count's mask and the attribute
// discard, and writes the kept row's position, velocity and colour into
// the slot in place; thread 0 of block 0 writes the advanced write cursor
// and spawn total into two new 0-d tensors. A window (or a sub-ring's
// segment) longer than its ring aims several rows at one slot, of which
// the newest kept one wins, as in the eager body's `_write_rows`: the
// slot's thread walks its rows from the newest down and writes the first
// that the mask and the discard keep. A window no longer than its ring
// gives each thread one row.
//
// Rounding: the file is compiled with -fmad=false, division and sqrtf are
// IEEE, sinf / cosf / fmodf are CUDA's precise forms (those torch's card
// kernels call), clamps and minima are fmaxf / fminf as torch's are, every
// formula keeps the eager operation order (torch.sum over a 3-wide axis
// adds (x^2 + z^2) + y^2 on the card) and every float32 constant is the
// one torch compares or multiplies with, so the kernel equals the eager
// body run on the card bit for bit (tests/test_torch_spawn_cuda.py).

#include <cuda_runtime.h>

#include "bezier.cuh"

namespace {

using namespace illum_bezier;

constexpr int kThreads = 256;

// A BezierM's segments: its header (min, inv_divisor, count, mode), then
// each control's (a, b, c, d) fields in this order.
enum ControlField { kMatrix = 0, kAngle, kScale, kTranslation, kIsDynamic,
                    kControlFields };
constexpr int kAnimationSegments = 1 + 4 * kControlFields;

// The uniform table's segments, in spawn_kernel.UNIFORM_SEGMENTS' order;
// the host gives each its offset in the block's copy.
enum Segment {
  kConfig = 0,      // (9, 4): ParticleSpawner.cs:220-227's pack
  kFormulaTypes,    // position, velocity, attribute, unused
  kPositionMatrix,  // (4, 4) static post-matrices (row-vector
  kVelocityMatrix,  // convention); an animation overwrites its copy
  kAxisMask,
  kAlign,           // align_velocity_and_position
  kDiscard,         // attribute_discard_threshold
  kPolygonRate,
  kPolygonLoop,
  kConstantCount,   // position_constant_count
  kPathHead,        // position_path: (min, inv_divisor, count, mode)
  kPathPoints,      // and its (4, 3) control points
  kAnimations,      // position_animation's segments, then velocity's
  kSegments = kAnimations + 2 * kAnimationSegments
};
// The block's copy of the uniform table holds at most this many floats.
constexpr int kMaxUniformFloats = 512;

// particles/formula.py's types and constants, as float32.
constexpr int kSpherical = 1, kTowards = 2, kRectangular = 3;
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kSqrt2 = (float)1.41421356237;
constexpr float kRadians = (float)(3.141592653589793 / 180.0);

struct Launch {
  float4* position;  // (N, 4) ring rows, written in place
  float4* velocity;
  float4* color;
  const int* write_cursor;  // () the ring's, before the spawn
  const int* total_spawned;
  int* out_cursor;  // () new tensors: the advanced cursor and total
  int* out_total;
  const float4* draws[3];        // (spawn_max, 4) random1..3
  const int* count_ptr;          // () or null: count_value
  const float* time_ptr;         // () or null: time_value
  const float4* constants;       // (P, 4) position constants
  const float4* colors;          // (P, 4) pattern colours, or null
  long long count_value;
  long long spawn_max, n_local, n_ranks, rank, sub_rings;
  long long first_segment, segments;  // the sub-rings this launch writes
  long long n_constants;         // P
  int path_constant;             // a constant path: its first point
  float time_value;
  float period[3];               // path, position, velocity animation
};

struct Table {
  const float* ptr[kSegments];  // null: absent, read as zeros
  int len[kSegments];           // floats to copy (<= its slot)
  int offset[kSegments + 1];    // each slot's first float; the end
};

// torch's integer remainder and floor division (Python's sign rules).
__device__ __forceinline__ long long mod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int mod32(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
// torch.remainder on float32 (fmod, then the divisor's sign).
__device__ __forceinline__ float torch_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// DynamicMatrix.regenerate of a dynamic control: rotation(angle) * scale
// + translation, row-major.
__device__ __forceinline__ void regenerate(float angle, float scale,
                                           float tx, float ty, float tz,
                                           float* m) {
  const float rad = angle * kRadians;
  const float c = cosf(rad) * scale;
  const float s = sinf(rad) * scale;
  const float out[16] = {c,    s,    0.0f,  0.0f, -s, c,  0.0f,  0.0f,
                         0.0f, 0.0f, scale, 0.0f, tx, ty, tz,    1.0f};
  for (int e = 0; e < 16; ++e) m[e] = out[e];
}

// Field f of control c of the animation whose table offsets start at
// `off` (its header's), staged in `u`.
__device__ __forceinline__ const float* control(const float* u,
                                                const int* off, int c,
                                                int f) {
  return u + off[1 + c * kControlFields + f];
}

// ops/bezier.py:evaluate_bezier_matrix of that animation at `value` -> m
// (4, 4) row-major: fully dynamic controls interpolate (angle, scale) and
// the translation, then regenerate; otherwise each control's regenerated
// matrix interpolates element by element.
__device__ void bezier_matrix(const float* u, const int* off, float value,
                              float* m) {
  float count;
  const float t = bezier_t(u + off[0], value, &count);
  bool fully_dynamic = true;
  for (int c = 0; c < 4; ++c)
    fully_dynamic &= *control(u, off, c, kIsDynamic) > 0.5f;
  if (fully_dynamic) {
    float angle_scale[8], translation[16];
    for (int c = 0; c < 4; ++c) {
      angle_scale[2 * c] = *control(u, off, c, kAngle);
      angle_scale[2 * c + 1] = *control(u, off, c, kScale);
      const float* tr = control(u, off, c, kTranslation);
      for (int i = 0; i < 3; ++i) translation[4 * c + i] = tr[i];
      translation[4 * c + 3] = 1.0f;
    }
    regenerate(bezier_channel(angle_scale, 2, count, t, 0),
               bezier_channel(angle_scale, 2, count, t, 1),
               bezier_channel(translation, 4, count, t, 0),
               bezier_channel(translation, 4, count, t, 1),
               bezier_channel(translation, 4, count, t, 2), m);
    return;
  }
  float rows[4 * 16];
  for (int c = 0; c < 4; ++c) {
    if (*control(u, off, c, kIsDynamic) > 0.5f) {
      const float* tr = control(u, off, c, kTranslation);
      regenerate(*control(u, off, c, kAngle), *control(u, off, c, kScale),
                 tr[0], tr[1], tr[2], rows + 16 * c);
    } else {
      const float* matrix = control(u, off, c, kMatrix);
      for (int e = 0; e < 16; ++e) rows[16 * c + e] = matrix[e];
    }
  }
  for (int e = 0; e < 16; ++e) {
    const float points[4] = {rows[e], rows[16 + e], rows[32 + e],
                             rows[48 + e]};
    m[e] = bezier_channel(points, 1, count, t, 0);
  }
}

// formula.py:generate_random_normal3 of (rx, ry), axis-masked and
// normalized.
__device__ __forceinline__ float3 random_normal(float rx, float ry,
                                                const float* axis) {
  const float phi = rx * kTwoPi;
  const float cos_theta = (ry - 0.5f) * 2.0f;
  const float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
  const float nx = sin_theta * cosf(phi) * axis[0];
  const float ny = sin_theta * sinf(phi) * axis[1];
  const float nz = cos_theta * axis[2];
  const float norm = sqrtf(fmaxf(nx * nx + nz * nz + ny * ny, 1e-12f));
  return make_float3(nx / norm, ny / norm, nz / norm);
}

// formula.py:evaluate_formula of one row; .w is the linear form (the
// constant's under "towards").
__device__ __forceinline__ float4 formula(float4 origin, float4 constant,
                                          float4 scale, float4 offset,
                                          float4 r, float type,
                                          const float* axis) {
  const int t = (int)fabsf(floorf(type));
  const float w = t == kTowards ? constant.w
                                : constant.w + (r.w + offset.w) * scale.w;
  if (t == kSpherical || t == kRectangular) {
    const float3 n = random_normal(r.x, r.y, axis);
    const float cx = n.x * r.z * scale.x, cy = n.y * r.z * scale.y,
                cz = n.z * r.z * scale.z;
    if (t == kSpherical)
      return make_float4(constant.x + cx + n.x * offset.x,
                         constant.y + cy + n.y * offset.y,
                         constant.z + cz + n.z * offset.z, w);
    const float ex = fabsf(offset.x), ey = fabsf(offset.y),
                ez = fabsf(offset.z);
    const float rx = fminf(fmaxf(offset.x * n.x * kSqrt2, -ex), ex);
    const float ry = fminf(fmaxf(offset.y * n.y * kSqrt2, -ey), ey);
    const float rz = fminf(fmaxf(offset.z * n.z * kSqrt2, -ez), ez);
    return make_float4(rx + constant.x + cx, ry + constant.y + cy,
                       rz + constant.z + cz, w);
  }
  if (t == kTowards) {
    const float tx = constant.x - origin.x, ty = constant.y - origin.y,
                tz = constant.z - origin.z;
    const float dist = sqrtf(fmaxf(tx * tx + tz * tz + ty * ty, 1e-12f));
    if (dist < 0.1f) return make_float4(0.0f, 0.0f, 0.0f, w);
    const float dx = tx / dist, dy = ty / dist, dz = tz / dist;
    return make_float4(r.x * scale.x * dx + offset.x * dx,
                       r.x * scale.y * dy + offset.y * dy,
                       r.x * scale.z * dz + offset.z * dz, w);
  }
  return make_float4(constant.x + (r.x + offset.x) * scale.x,
                     constant.y + (r.y + offset.y) * scale.y,
                     constant.z + (r.z + offset.z) * scale.z, w);
}

// coords.py:mul_point_rows: mul(float4(v.xyz, 1), M), v.w kept.
__device__ __forceinline__ float4 mul_point(float4 v, const float* m) {
  return make_float4(v.x * m[0] + v.y * m[4] + v.z * m[8] + m[12],
                     v.x * m[1] + v.y * m[5] + v.z * m[9] + m[13],
                     v.x * m[2] + v.y * m[6] + v.z * m[10] + m[14], v.w);
}

__device__ __forceinline__ float4 row4(const float* u) {
  return make_float4(u[0], u[1], u[2], u[3]);
}

// The spawned row of window row j (spawn ordinal `order`): its position,
// velocity and colour, Spawn_Stage1/2 of the eager body; `u` the staged
// table at offsets `off`, `path` the emission path's value or null.
__device__ __forceinline__ void spawn_row(const Launch& L, const float* u,
                                          const int* off, const float* path,
                                          long long j, long long order,
                                          int total, float4* out) {
  float4 r1 = __ldg(L.draws[0] + j), r2 = __ldg(L.draws[1] + j),
         r3 = __ldg(L.draws[2] + j);
  if (u[off[kAlign]] > 0.5f) {
    r2.x = r1.x;
    r2.y = r1.y;
  }

  // Position constant: cycle one per particle, or walk the polygon path
  // (fxh:136-155); the cross-tick offset wraps in int32 at a multiple of
  // the constant count.
  const float constant_count = u[off[kConstantCount]];
  const float p_count = fmaxf(constant_count, 1.0f);
  int p_ci = (int)constant_count;
  p_ci = p_ci < 1 ? 1 : p_ci;
  const int total_w = mod32(total, p_ci * 4096);
  const float relf = (float)(order + (long long)total_w);
  const float rate = u[off[kPolygonRate]];
  const bool use_poly = rate > 0.05f;
  float idx1, idx2, t;
  if (use_poly) {
    const float pos_f = relf / fmaxf(rate, 1e-3f);
    const float pos_i = floorf(pos_f);
    t = pos_f - pos_i;
    idx1 = torch_remainder(pos_i, p_count);
    idx2 = u[off[kPolygonLoop]] > 0.5f
               ? torch_remainder(pos_i + 1.0f, p_count)
               : fminf(idx1 + 1.0f, p_count - 1.0f);
  } else {
    idx1 = idx2 = torch_remainder(relf, p_count);
    t = 0.0f;
  }
  long long i1 = (long long)idx1, i2 = (long long)idx2;
  i1 = i1 < 0 ? 0 : (i1 >= L.n_constants ? L.n_constants - 1 : i1);
  i2 = i2 < 0 ? 0 : (i2 >= L.n_constants ? L.n_constants - 1 : i2);
  float4 p1 = __ldg(L.constants + i1), p2 = __ldg(L.constants + i2);
  if (path) {
    p1.x = p2.x = path[0];
    p1.y = p2.y = path[1];
    p1.z = p2.z = path[2];
  }
  const float4 pc = make_float4(
      p1.x + (p2.x - p1.x) * t, p1.y + (p2.y - p1.y) * t,
      p1.z + (p2.z - p1.z) * t, p1.w + (p2.w - p1.w) * t);
  const float nx = p2.x - p1.x, ny = p2.y - p1.y, nz = p2.z - p1.z;

  // Spawn_Stage2 (fxh:157-190).
  const float* cfg = u + off[kConfig];
  const float* types = u + off[kFormulaTypes];
  const float* axis = u + off[kAxisMask];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 temp_position = formula(zero, pc, row4(cfg), row4(cfg + 4),
                                       r1, types[0], axis);
  out[0] = mul_point(temp_position, u + off[kPositionMatrix]);
  float4 temp_velocity = formula(temp_position, row4(cfg + 8),
                                 row4(cfg + 12), row4(cfg + 16), r2,
                                 types[1], axis);
  // Velocity along the polygon path (fxh:172-177): config row 8.
  const float towards_len = sqrtf(fmaxf(nx * nx + nz * nz + ny * ny, 1e-12f));
  const float speed = cfg[32] + (r3.w + cfg[34]) * cfg[33];
  const bool along = towards_len > 1e-4f;
  temp_velocity.x = temp_velocity.x + (along ? speed * nx / towards_len
                                             : 0.0f);
  temp_velocity.y = temp_velocity.y + (along ? speed * ny / towards_len
                                             : 0.0f);
  temp_velocity.z = temp_velocity.z + (along ? speed * nz / towards_len
                                             : 0.0f);
  out[1] = mul_point(temp_velocity, u + off[kVelocityMatrix]);
  float4 attr_constant = row4(cfg + 20);
  if (L.colors) {
    // The pattern pixel's colour multiplies the colour constant.
    const float4 c = __ldg(L.colors + i1);
    attr_constant = make_float4(attr_constant.x * c.x, attr_constant.y * c.y,
                                attr_constant.z * c.z, attr_constant.w * c.w);
  }
  out[2] = formula(zero, attr_constant, row4(cfg + 24), row4(cfg + 28), r3,
                   types[2], axis);
}

__global__ void __launch_bounds__(kThreads)
    spawn_kernel(const Launch L, const Table T) {
  __shared__ float u[kMaxUniformFloats];
  __shared__ int off[kSegments];
  __shared__ float path[3];
  for (int s = threadIdx.x; s < kSegments; s += kThreads) {
    off[s] = T.offset[s];
    float* dst = u + T.offset[s];
    const int slot = T.offset[s + 1] - T.offset[s];
    const int len = T.ptr[s] ? T.len[s] : 0;
    for (int k = 0; k < slot; ++k)
      dst[k] = k < len ? __ldg(T.ptr[s] + k) : 0.0f;
  }
  __syncthreads();
  const long long count_in = L.count_ptr ? (long long)*L.count_ptr
                                         : L.count_value;
  const int cursor = *L.write_cursor;
  const int total = *L.total_spawned;
  if (threadIdx.x == 0) {
    const float time = L.time_ptr ? *L.time_ptr : L.time_value;
    float at[3];
    for (int i = 0; i < 3; ++i)
      at[i] = L.period[i] > 0.0f ? torch_remainder(time, L.period[i])
                                 : time;
    if (T.ptr[kPathHead]) {
      const float* points = u + off[kPathPoints];
      float count, t = 0.0f;
      if (!L.path_constant) t = bezier_t(u + off[kPathHead], at[0],
                                         &count);
      for (int c = 0; c < 3; ++c)
        path[c] = L.path_constant ? points[c]
                                  : bezier_channel(points, 3, count, t, c);
    }
    if (T.ptr[kAnimations])
      bezier_matrix(u, off + kAnimations, at[1], u + off[kPositionMatrix]);
    if (T.ptr[kAnimations + kAnimationSegments])
      bezier_matrix(u, off + kAnimations + kAnimationSegments, at[2],
                    u + off[kVelocityMatrix]);
    if (blockIdx.x == 0) {
      // spawner.py:_advance with the count as the spawn rounds it.
      const long long count =
          floor_div(count_in, L.sub_rings) * L.sub_rings;
      const long long n = L.n_local * L.n_ranks;
      *L.out_cursor = mod32((int)((unsigned)cursor + (unsigned)count),
                            (int)n);
      *L.out_total = (int)((unsigned)total + (unsigned)count);
    }
  }
  __syncthreads();

  // The thread's slot (spawner.py:spawn's index plan): segment q of
  // `sub_rings` (one, the whole ring, without them) takes row r of its
  // `seg` rows, the first `per` of them kept by the count, into slot
  // (local cursor + r) mod `block` of its `block` slots; `lanes` threads
  // a segment, one a slot, each starting from the newest row aimed at it.
  const long long n = L.n_local * L.n_ranks;
  const long long seg = L.spawn_max / L.sub_rings, block = n / L.sub_rings;
  const long long lanes = seg < block ? seg : block;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= L.segments * lanes) return;
  const long long q = L.first_segment + g / lanes;
  const long long newest = seg - lanes + g % lanes;
  const long long per = floor_div(count_in, L.sub_rings);
  const long long local = mod(floor_div((long long)cursor, L.sub_rings),
                              block);
  const long long idx =
      q * block + mod(local + newest, block) - L.rank * L.n_local;
  if (idx < 0 || idx >= L.n_local) return;  // another rank's slot
  const float discard = u[off[kDiscard]];
  for (long long r = newest; r >= 0; r -= block) {
    if (r >= per) continue;
    float4 row[3];
    spawn_row(L, u, off, T.ptr[kPathHead] ? path : nullptr, q * seg + r,
              q * per + r, total, row);
    if (row[2].w >= discard) {
      L.position[idx] = row[0];
      L.velocity[idx] = row[1];
      L.color[idx] = row[2];
      return;
    }
  }
}

}  // namespace

// ptrs: position, velocity, color, write_cursor, total_spawned,
// out_cursor, out_total, random1..3, count (or null), time (or null),
// position_constants, position_colors (or null), then the kSegments
// uniform tensors (null: absent). ints: count (where its pointer is
// null), spawn_max, capacity (the local ring), ranks, rank, sub_rings,
// the first sub-ring and the sub-rings this launch writes, position
// constants, constant path; then each segment's floats, then each
// segment's offset in the block's copy and the copy's end. floats: time
// (where its pointer is null), the path's and the two animations'
// periods.
extern "C" int k4b_spawn(const void* const* ptrs, const long long* ints,
                         const float* floats, void* stream) {
  Launch L;
  L.position = (float4*)ptrs[0];
  L.velocity = (float4*)ptrs[1];
  L.color = (float4*)ptrs[2];
  L.write_cursor = (const int*)ptrs[3];
  L.total_spawned = (const int*)ptrs[4];
  L.out_cursor = (int*)ptrs[5];
  L.out_total = (int*)ptrs[6];
  for (int i = 0; i < 3; ++i) L.draws[i] = (const float4*)ptrs[7 + i];
  L.count_ptr = (const int*)ptrs[10];
  L.time_ptr = (const float*)ptrs[11];
  L.constants = (const float4*)ptrs[12];
  L.colors = (const float4*)ptrs[13];
  L.count_value = ints[0];
  L.spawn_max = ints[1];
  L.n_local = ints[2];
  L.n_ranks = ints[3];
  L.rank = ints[4];
  L.sub_rings = ints[5];
  L.first_segment = ints[6];
  L.segments = ints[7];
  L.n_constants = ints[8];
  L.path_constant = (int)ints[9];
  L.time_value = floats[0];
  for (int i = 0; i < 3; ++i) L.period[i] = floats[1 + i];
  const long long n = L.n_local * L.n_ranks;
  if (L.n_constants < 1 || L.n_local < 1 || L.n_ranks < 1 ||
      L.sub_rings < 1 || L.spawn_max < 0 || L.spawn_max % L.sub_rings ||
      n % L.sub_rings || n >= (1LL << 31) || L.first_segment < 0 ||
      L.segments < 0 || L.first_segment + L.segments > L.sub_rings)
    return (int)cudaErrorInvalidValue;
  Table T;
  T.offset[0] = (int)ints[10 + kSegments];
  for (int s = 0; s < kSegments; ++s) {
    T.ptr[s] = (const float*)ptrs[14 + s];
    T.offset[s + 1] = (int)ints[11 + kSegments + s];
    const long long len = ints[10 + s];
    const int slot = T.offset[s + 1] - T.offset[s];
    if (slot < 0 || len < 0 || (T.ptr[s] && len > slot))
      return (int)cudaErrorInvalidValue;
    T.len[s] = (int)len;
  }
  if (T.offset[0] != 0 || T.offset[kSegments] > kMaxUniformFloats)
    return (int)cudaErrorInvalidValue;
  const long long seg = L.spawn_max / L.sub_rings, block = n / L.sub_rings;
  const long long threads = L.segments * (seg < block ? seg : block);
  const long long blocks = threads > 0 ? (threads + kThreads - 1) / kThreads
                                       : 1;
  spawn_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(L, T);
  return (int)cudaGetLastError();
}

extern "C" int k4b_spawn_plan(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, spawn_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, spawn_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = blocks;
  out[4] = (int)attr.sharedSizeBytes;
  return 0;
}
