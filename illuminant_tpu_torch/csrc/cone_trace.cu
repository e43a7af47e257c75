// K12: the cone-trace march (ConeTrace.fxh) for Hopper (sm_90a).
//
// Replaces the XLA `lax.while_loop` of illuminant_tpu/lighting/
// cone_trace.py:cone_trace (:42-148; the JAX package has no Pallas kernel
// for it) and, in the port, the plain loop of lighting/cone_trace.py,
// which walks the whole ray tensor a step at a time (~100 small kernels a
// step) and reads the device once a step to learn whether any ray is
// still live (177 reads a frame of renderer-voxel-march-1080p).
//
// One thread a ray. A ray is (light l, point p): each argument is an
// array with an element stride per light and per point (0 where it is
// broadcast), so the sphere lights' (L, H, W) rays, the line light's and
// the directional lights' per-point centers and the projector's single
// light all launch once, without copies. Where the rays are (L, H, W), a
// block takes a 16 x 16 square of one light's points (neighbouring rays
// sample neighbouring texels); else 256 rays in order. The thread computes
// the trace config (fxh:122-139), then marches: sample the field, shrink
// the visibility by the ratio of the distance to the local cone radius,
// step by max(|d| * long_step_factor, min_step), until the step budget,
// the threshold or the ray's end stops it (fxh:73-82, 141-191). The whole
// loop lives in registers; a dead ray leaves its loop, and nothing is
// read back to the host. The epilogue ramps the visibility by the steps
// left and, unless `raw`, thresholds and raises it to the opacity power.
//
// The field is sampled by the device functions of sdf_fields.cuh: the
// exact trilinear SdfVolume, the closed-form AnalyticScene (primitives
// and extruded polygons), or the ColumnField reconstruction
// (column_query.cuh, shared with K7 and K10), one kernel instance each
// (two for the scene: the Instance enum).
//
// What bounds it on an H100: instruction issue, not bytes or divergence.
// Its warps are 84-91% efficient and nothing spills, yet the first cut
// (PR 12) ran ~0.8 ray-steps an SM clock on renderer-voxel-march-1080p:
// ~150 SASS instructions a step against the ~37 operations the bound
// counts. `cuobjdump -sass` of that build (chip_smoke.py's [build] line,
// `march_loop_sass`) gives the march loop bodies: 196 instructions
// (SdfVolume), 802 (AnalyticScene, its primitive loop 493), 194
// (ColumnField); a third of the volume's went to 64-bit tap addresses
// and eight loads, and the scene's records were 12 global loads a
// primitive a step. This design cuts the work a step, every rounding
// unchanged:
//   * 32-bit offsets (the wrapper refuses arrays that reach 2^31);
//   * the volume's max_valid_z read once a ray, not once a step;
//   * the volume's 2 x 2 xy taps packed into one 16-byte record a texel,
//     the edge clamp baked in (pack_volume_kernel, once a new volume):
//     two loads a sample, not eight; its loop is 139 instructions;
//   * the scene's records (and polygons) staged in shared memory once a
//     block: three 16-byte loads a primitive;
//   * the root of the distance to the box skipped inside it, where it is
//     +0 exactly;
//   * 16 x 16 ray tiles, and __launch_bounds__ raised where it keeps the
//     instance free of spills (tools/torch_march_study.py times each
//     choice).
// PERF.md section 6 gives the times against the parent's.
//
// The file is compiled with -fmad=false and every formula keeps the plain
// version's operation order. Its sqrtf is correctly rounded, where
// torch's float32 sqrt on the card is not everywhere. Still a few rays
// in millions take another step count than the plain version on an H100
// (as many against a plain version with correctly rounded roots, so the
// root does not decide them); the comparison is bounded and gates the
// share of such rays.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sdf_fields.cuh"

namespace {

using namespace illum_fields;

constexpr int kThreads = 256;
constexpr int kTile = 16;  // a block's square of one light's image points
static_assert(kTile * kTile == kThreads, "one ray tile a block");
// The AnalyticScene's arrays go to shared memory up to this size.
constexpr int kAnalyticSmemMax = 48 * 1024;

// ConeTrace.fxh:1-29.
constexpr float kMinConeRadius = 0.33f;
constexpr float kMaxStepRampWindow = 2.0f;
constexpr float kTraceInitialOffset = 0.5f;
constexpr float kFullyShadowed = 0.075f;
constexpr float kUnshadowed = 0.95f;
constexpr float kHackDistanceOffset = 1.5f;

// An argument array: element (l, p, c) at ptr[l * sl + p * sp + c * sc],
// in 32-bit offsets (the wrapper refuses a view that reaches 2^31).
struct Strided {
  const void* ptr;
  int sl, sp, sc;
};

__device__ __forceinline__ float at(const Strided& a, int l, int p,
                                    int c = 0) {
  return __ldg((const float*)a.ptr + (l * a.sl + p * a.sp + c * a.sc));
}

struct Rays {
  Strided center, radius, ramp, origin, enable;
  int lights, points;
  // The points' image (height, width) when a block takes a kTile x kTile
  // square of one light's points; width 0: a block takes 256 rays in order.
  int height, width;
  float* out;
  float* steps_out;  // null unless the caller asks for the steps left
};

struct Quality {
  float min_step, long_step_factor, max_cone_radius, cone_growth_factor,
      power;
  int max_steps, raw;
};

// The kernel's instances: the field kind, and how its data is read.
enum Instance {
  kVolume = 0,          // SdfVolume, 2 packed 16-byte loads a sample
  kAnalytic = 1,        // AnalyticScene, its arrays in shared memory
  kColumn = 2,          // ColumnField (column_query.cuh)
  kAnalyticGlobal = 3   // AnalyticScene too large for shared memory
};

// x ** power as torch.pow(tensor, scalar) computes it for the powers it
// special-cases, powf otherwise.
__device__ __forceinline__ float scalar_pow(float x, float p) {
  if (p == 1.0f) return x;
  if (p == 2.0f) return x * x;
  if (p == 0.5f) return sqrtf(x);
  return powf(x, p);
}

// __launch_bounds__' minimum blocks an SM, each instance's: the most that
// keeps it free of spills (the analytic instances spill at 5;
// tools/torch_march_study.py times the others).
template <int F>
constexpr int min_blocks() {
  return F == kColumn ? 5 : F == kVolume ? 6 : 1;
}

template <int F>
__global__ void __launch_bounds__(kThreads, min_blocks<F>())
    cone_trace_kernel(Rays r, Quality q, FieldTable f) {
  extern __shared__ float4 smem4[];
  int l, p;
  bool valid;
  if (r.width > 0) {
    const int tiles_x = (r.width + kTile - 1) / kTile;
    const int per_light = tiles_x * ((r.height + kTile - 1) / kTile);
    l = blockIdx.x / per_light;
    const int t = blockIdx.x - l * per_light;
    const int ty = t / tiles_x;
    const int y = ty * kTile + threadIdx.x / kTile;
    const int x = (t - ty * tiles_x) * kTile + threadIdx.x % kTile;
    valid = y < r.height && x < r.width;
    p = y * r.width + x;
  } else {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    valid = i < r.lights * r.points;
    l = i / r.points;
    p = i - l * r.points;
  }
  Analytic scene = f.analytic;
  if (F == kAnalytic)
    scene = stage_analytic(f.analytic, (float*)smem4, kThreads);
  if (!valid) return;
  const int i = l * r.points + p;
  // The volume's max_valid_z, read once a ray rather than once a step.
  float max_valid_z = 0.0f;
  if (F == kVolume) max_valid_z = __ldg(f.volume.max_valid_z);

  const bool enable =
      __ldg((const unsigned char*)r.enable.ptr + l * r.enable.sl +
            p * r.enable.sp) != 0;
  const float ox = at(r.origin, l, p, 0);
  const float oy = at(r.origin, l, p, 1);
  const float oz = at(r.origin, l, p, 2);
  const float light_radius = at(r.radius, l, p);

  // The trace config (fxh:46-47, 122-139), in the plain version's order.
  const float tvx = at(r.center, l, p, 0) - ox;
  const float tvy = at(r.center, l, p, 1) - oy;
  const float tvz = at(r.center, l, p, 2) - oz;
  const float trace_length =
      sqrtf(fmaxf(tvx * tvx + tvy * tvy + tvz * tvz, 1e-12f));
  const float dx = tvx / trace_length;
  const float dy = tvy / trace_length;
  const float dz = tvz / trace_length;
  const float end_offset = fmaxf(trace_length - light_radius, 1.0f);
  const float max_radius =
      fminf(fmaxf(light_radius, kMinConeRadius), q.max_cone_radius);
  const float growth = max_radius / fmaxf(at(r.ramp, l, p), 16.0f) *
                       q.cone_growth_factor;

  float offset = kTraceInitialOffset;
  float vis = 1.0f;
  float steps = (float)q.max_steps;
  bool live = enable;
  for (int k = 0; k < q.max_steps && live; ++k) {
    steps = steps - 1.0f;
    // coneTraceAdvance (fxh:73-82).
    const float sx = ox + dx * offset, sy = oy + dy * offset,
                sz = oz + dz * offset;
    float d;
    if (F == kVolume)
      d = volume_distance(f.volume, max_valid_z, sx, sy, sz);
    else if (F == kAnalytic)
      d = analytic_distance<true>(scene, sx, sy, sz);
    else if (F == kAnalyticGlobal)
      d = analytic_distance<false>(scene, sx, sy, sz);
    else
      d = column_distance(f.column, sx, sy, sz);
    const float local_radius =
        fminf(growth * offset + kMinConeRadius, max_radius);
    vis = fminf(vis, (d + kHackDistanceOffset) / local_radius);
    offset = offset + fmaxf(fabsf(d) * q.long_step_factor, q.min_step);
    // liveness = stepsRemaining * saturate(vis - threshold)
    //            * saturate(end - offset)   (fxh:81, 163-170)
    const bool step_live =
        clamp01(vis - kFullyShadowed) * clamp01(end_offset - offset) > 0.0f;
    live = step_live && steps > 0.0f;
  }

  // The step-budget ramp (fxh:175-180) and the epilogue.
  const float visibility = fminf(vis, steps / kMaxStepRampWindow);
  float result;
  if (!enable) {
    result = 1.0f;
  } else if (q.raw) {
    result = visibility;
  } else {
    result = scalar_pow(clamp01(clamp01(visibility - kFullyShadowed) /
                                (kUnshadowed - kFullyShadowed)),
                        q.power);
  }
  r.out[i] = result;
  if (r.steps_out) r.steps_out[i] = steps;
}

// Each texel's 2 x 2 xy taps of an (S, H, W) volume as one float4:
// (s, y, x), (s, y, x1), (s, y1, x), (s, y1, x1) with x1 = min(x + 1,
// W - 1) and y1 = min(y + 1, H - 1), as sampling.sample clamps them.
__global__ void __launch_bounds__(kThreads)
    pack_volume_kernel(const float* data, int slices, int height, int width,
                       float4* out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= slices * height * width) return;
  const int x = i % width;
  const int sy = i / width;
  const int y = sy % height;
  const float* d = data + (sy / height) * height * width;
  const int x1 = min(x + 1, width - 1), y1 = min(y + 1, height - 1);
  out[i] = make_float4(__ldg(d + y * width + x), __ldg(d + y * width + x1),
                       __ldg(d + y1 * width + x), __ldg(d + y1 * width + x1));
}

const void* instance_fn(int instance) {
  switch (instance) {
    case kVolume:
      return (const void*)cone_trace_kernel<kVolume>;
    case kAnalytic:
      return (const void*)cone_trace_kernel<kAnalytic>;
    case kColumn:
      return (const void*)cone_trace_kernel<kColumn>;
    case kAnalyticGlobal:
      return (const void*)cone_trace_kernel<kAnalyticGlobal>;
    default:
      return nullptr;
  }
}

Strided strided(const void* ptr, const long long* s) {
  return Strided{ptr, (int)s[0], (int)s[1], (int)s[2]};
}

}  // namespace

// ptrs: center, radius, ramp, origin, enable, out, steps_out (or null),
//       then the field's: volume pack, max_valid_z |
//       primitive records, polygon vertices, next vertices, z range,
//       active | column pack.
// strides: (sl, sp, sc) for center, radius, ramp, origin, enable.
// ints: lights, points, field kind (0 volume, 1 analytic, 2 column),
//       max_steps, raw, image height, image width (0: rays in order),
//       then the field's: slices, height, width | count, batched,
//       polygons, edges | hc, wc.
// floats: min_step, long_step_factor, max_cone_radius, cone_growth_factor,
//       power, then the field's: ex, ey, ez, z_offset, z_to_slice,
//       scale_x, scale_y | maximum_distance | the 12 column geometry.
// `instance`: the kernel instance to launch (the Instance enum), one of
// the field kind's; kAnalytic needs a scene whose arrays fit in a block's
// shared memory.
extern "C" int cone_trace(const void* const* ptrs, const long long* strides,
                          const long long* ints, const float* floats,
                          int instance, void* stream) {
  Rays r;
  r.center = strided(ptrs[0], strides + 0);
  r.radius = strided(ptrs[1], strides + 3);
  r.ramp = strided(ptrs[2], strides + 6);
  r.origin = strided(ptrs[3], strides + 9);
  r.enable = strided(ptrs[4], strides + 12);
  r.out = (float*)ptrs[5];
  r.steps_out = (float*)ptrs[6];
  r.lights = (int)ints[0];
  r.points = (int)ints[1];
  const int kind = (int)ints[2];
  Quality q;
  q.max_steps = (int)ints[3];
  q.raw = (int)ints[4];
  r.height = (int)ints[5];
  r.width = (int)ints[6];
  q.min_step = floats[0];
  q.long_step_factor = floats[1];
  q.max_cone_radius = floats[2];
  q.cone_growth_factor = floats[3];
  q.power = floats[4];
  const long long* fi = ints + 7;
  const float* ff = floats + 5;
  const void* const* fp = ptrs + 7;
  if (ints[0] * ints[1] >= (1LL << 31)) return (int)cudaErrorInvalidValue;

  FieldTable f;
  if (!fields_from(kind, fi, ff, fp, &f)) return (int)cudaErrorInvalidValue;
  const int inst = instance;
  size_t smem = 0;
  if (kind == kVolume) {
    if (inst != kVolume) return (int)cudaErrorInvalidValue;
  } else if (kind == kAnalytic) {
    if (inst == kAnalytic) {
      smem = sizeof(float) * (size_t)analytic_floats(f.analytic);
      if (smem > (size_t)kAnalyticSmemMax) return (int)cudaErrorInvalidValue;
    } else if (inst != kAnalyticGlobal) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (inst != kColumn) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)r.lights * r.points;
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  unsigned int blocks;
  if (r.width > 0) {
    if ((long long)r.height * r.width != r.points)
      return (int)cudaErrorInvalidValue;
    blocks = (unsigned int)(r.lights * ((r.height + kTile - 1) / kTile) *
                            ((r.width + kTile - 1) / kTile));
  } else {
    blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  }
  switch (inst) {
    case kVolume:
      cone_trace_kernel<kVolume><<<blocks, kThreads, 0, st>>>(r, q, f);
      break;
    case kAnalytic:
      cone_trace_kernel<kAnalytic><<<blocks, kThreads, smem, st>>>(r, q, f);
      break;
    case kAnalyticGlobal:
      cone_trace_kernel<kAnalyticGlobal><<<blocks, kThreads, 0, st>>>(r, q,
                                                                       f);
      break;
    default:
      cone_trace_kernel<kColumn><<<blocks, kThreads, 0, st>>>(r, q, f);
      break;
  }
  return (int)cudaGetLastError();
}

// The packed volume (Volume::pack) of an (S, H, W) float32 volume into
// `out`, (S, H, W) float4: one launch.
extern "C" int cone_trace_pack_volume(const float* data, int slices,
                                      int height, int width, void* out,
                                      void* stream) {
  const long long n = (long long)slices * height * width;
  if (n <= 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  pack_volume_kernel<<<(unsigned int)((n + kThreads - 1) / kThreads),
                       kThreads, 0, (cudaStream_t)stream>>>(
      data, slices, height, width, (float4*)out);
  return (int)cudaGetLastError();
}

// The block of kernel instance `instance` (the Instance enum) with
// `smem` bytes of dynamic shared memory: threads, registers and spilled
// bytes a thread, resident blocks an SM.
extern "C" int cone_trace_plan(int instance, int smem, int* out) {
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
