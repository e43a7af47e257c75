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
// light all launch once, without copies. The thread computes the trace
// config (fxh:122-139), then marches: sample the field, shrink the
// visibility by the ratio of the distance to the local cone radius, step
// by max(|d| * long_step_factor, min_step), until the step budget, the
// threshold or the ray's end stops it (fxh:73-82, 141-191). The whole
// loop lives in registers; a dead ray leaves its loop, and nothing is
// read back to the host. The epilogue ramps the visibility by the steps
// left and, unless `raw`, thresholds and raises it to the opacity power.
//
// The field is sampled by the device functions of sdf_fields.cuh: the
// exact trilinear SdfVolume, the closed-form AnalyticScene (primitives
// and extruded polygons), or the ColumnField reconstruction
// (column_query.cuh, shared with K7 and K10), one kernel instance each.
//
// What bounds it on an H100: the field's samples. At renderer-voxel-
// march-1080p 16.6M rays take up to 64 steps of an 8-tap trilinear
// sample (~40 float operations and 8 cached 4-byte loads each); the
// rays' own bytes (origin, centre, radius, ramp, enable in; visibility
// out) are small beside that. This first cut reads the field through the
// read-only cache and keeps each ray's loop in registers; a warp runs as
// long as its slowest ray (the divergence chip_smoke.py measures).
// Staging the field in shared memory and compacting live rays are later
// work.
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

// ConeTrace.fxh:1-29.
constexpr float kMinConeRadius = 0.33f;
constexpr float kMaxStepRampWindow = 2.0f;
constexpr float kTraceInitialOffset = 0.5f;
constexpr float kFullyShadowed = 0.075f;
constexpr float kUnshadowed = 0.95f;
constexpr float kHackDistanceOffset = 1.5f;

// An argument array: element (l, p, c) at ptr[l * sl + p * sp + c * sc].
struct Strided {
  const void* ptr;
  long long sl, sp, sc;
};

__device__ __forceinline__ float at(const Strided& a, long long l,
                                    long long p, int c = 0) {
  return __ldg((const float*)a.ptr + l * a.sl + p * a.sp + c * a.sc);
}

struct Rays {
  Strided center, radius, ramp, origin, enable;
  long long lights, points;
  float* out;
  float* steps_out;  // null unless the caller asks for the steps left
};

struct Quality {
  float min_step, long_step_factor, max_cone_radius, cone_growth_factor,
      power;
  int max_steps, raw;
};

enum FieldKind { kVolume = 0, kAnalytic = 1, kColumn = 2 };

struct Fields {
  Volume volume;
  Analytic analytic;
  Column column;
};

template <int F>
__device__ __forceinline__ float field_sample(const Fields& f, float x,
                                              float y, float z) {
  if (F == kVolume) return volume_distance(f.volume, x, y, z);
  if (F == kAnalytic) return analytic_distance(f.analytic, x, y, z);
  return column_distance(f.column, x, y, z);
}

// x ** power as torch.pow(tensor, scalar) computes it for the powers it
// special-cases, powf otherwise.
__device__ __forceinline__ float scalar_pow(float x, float p) {
  if (p == 1.0f) return x;
  if (p == 2.0f) return x * x;
  if (p == 0.5f) return sqrtf(x);
  return powf(x, p);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    cone_trace_kernel(Rays r, Quality q, Fields f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.lights * r.points) return;
  const long long l = i / r.points;
  const long long p = i - l * r.points;

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
    const float d = field_sample<F>(f, ox + dx * offset, oy + dy * offset,
                                    oz + dz * offset);
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

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

Strided strided(const void* ptr, const long long* s) {
  return Strided{ptr, s[0], s[1], s[2]};
}

}  // namespace

// ptrs: center, radius, ramp, origin, enable, out, steps_out (or null),
//       then the field's: volume data, max_valid_z | primitive records,
//       polygon vertices, next vertices, z range, active | column pack.
// strides: (sl, sp, sc) for center, radius, ramp, origin, enable.
// ints: lights, points, field kind, max_steps, raw, then the field's:
//       slices, height, width | count, batched, polygons, edges | hc, wc.
// floats: min_step, long_step_factor, max_cone_radius, cone_growth_factor,
//       power, then the field's: ex, ey, ez, z_offset, z_to_slice,
//       scale_x, scale_y | maximum_distance | the 12 column geometry.
extern "C" int cone_trace(const void* const* ptrs, const long long* strides,
                          const long long* ints, const float* floats,
                          void* stream) {
  Rays r;
  r.center = strided(ptrs[0], strides + 0);
  r.radius = strided(ptrs[1], strides + 3);
  r.ramp = strided(ptrs[2], strides + 6);
  r.origin = strided(ptrs[3], strides + 9);
  r.enable = strided(ptrs[4], strides + 12);
  r.out = (float*)ptrs[5];
  r.steps_out = (float*)ptrs[6];
  r.lights = ints[0];
  r.points = ints[1];
  const int kind = (int)ints[2];
  Quality q;
  q.max_steps = (int)ints[3];
  q.raw = (int)ints[4];
  q.min_step = floats[0];
  q.long_step_factor = floats[1];
  q.max_cone_radius = floats[2];
  q.cone_growth_factor = floats[3];
  q.power = floats[4];
  const long long* fi = ints + 5;
  const float* ff = floats + 5;
  const void* const* fp = ptrs + 7;

  Fields f = {};
  if (kind == kVolume) {
    f.volume.data = (const float*)fp[0];
    f.volume.max_valid_z = (const float*)fp[1];
    f.volume.slices = (int)fi[0];
    f.volume.height = (int)fi[1];
    f.volume.width = (int)fi[2];
    f.volume.ex = ff[0];
    f.volume.ey = ff[1];
    f.volume.ez = ff[2];
    f.volume.z_offset = ff[3];
    f.volume.z_to_slice = ff[4];
    f.volume.scale_x = ff[5];
    f.volume.scale_y = ff[6];
  } else if (kind == kAnalytic) {
    f.analytic.records = (const float*)fp[0];
    f.analytic.count = (int)fi[0];
    f.analytic.batched = (int)fi[1];
    f.analytic.polygons.count = (int)fi[2];
    f.analytic.polygons.edges = (int)fi[3];
    f.analytic.polygons.vertices = (const float*)fp[1];
    f.analytic.polygons.next_vertices = (const float*)fp[2];
    f.analytic.polygons.z_range = (const float*)fp[3];
    f.analytic.polygons.active = (const float*)fp[4];
    f.analytic.maximum_distance = ff[0];
  } else if (kind == kColumn) {
    f.column.pack = (const float*)fp[0];
    f.column.hc = (int)fi[0];
    f.column.wc = (int)fi[1];
    f.column.g = illum_columns::geometry_from(ff);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = r.lights * r.points;
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = blocks_for(n);
  switch (kind) {
    case kVolume:
      cone_trace_kernel<kVolume><<<blocks, kThreads, 0, st>>>(r, q, f);
      break;
    case kAnalytic:
      cone_trace_kernel<kAnalytic><<<blocks, kThreads, 0, st>>>(r, q, f);
      break;
    default:
      cone_trace_kernel<kColumn><<<blocks, kThreads, 0, st>>>(r, q, f);
      break;
  }
  return (int)cudaGetLastError();
}

// The block a launch of field kind `kind` takes: threads, registers and
// spilled bytes a thread, and resident blocks an SM.
extern "C" int cone_trace_plan(int kind, int* out) {
  cudaFuncAttributes attr;
  const void* fn = kind == kVolume
                       ? (const void*)cone_trace_kernel<kVolume>
                       : kind == kAnalytic
                             ? (const void*)cone_trace_kernel<kAnalytic>
                             : (const void*)cone_trace_kernel<kColumn>;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = blocks;
  return 0;
}
