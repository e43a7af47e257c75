// The clamped bezier (ops/bezier.py) as device functions, shared by the
// collision integrate's render data (collide_integrate.cu, K4) and the
// spawn's animated uniforms (spawn.cu, K4b).
//
// `bezier_t` is t_for_scaled_bezier at one value and `bezier_channel`
// evaluate_at_t of one channel, each in the plain version's order. Every
// file that includes this header is compiled with -fmad=false, so the
// products and sums round one by one as torch's kernels round them on the
// card; sinf and fmodf are CUDA's precise forms, those torch calls.

#pragma once

#include <cuda_runtime.h>

namespace illum_bezier {

// ops/bezier.py:t_for_scaled_bezier at `value` -> t; *count the header's.
__device__ __forceinline__ float bezier_t(const float* head, float value,
                                          float* count) {
  const float min_value = head[0], inv_divisor = head[1];
  *count = head[2];
  const int mode = (int)fabsf(head[3]);
  const bool repeating = mode > 255;
  const bool bouncing = mode > 511;
  const bool reverse = inv_divisor < 0.0f;
  float t = (value - min_value) * fabsf(inv_divisor);
  if (bouncing) {
    float tb = t * 2.0f;
    const float m2 = fmodf(tb, 2.0f);
    tb = reverse ? 2.0f - m2 : m2;
    t = tb > 1.0f ? 2.0f - tb : tb;
  } else if (repeating) {
    const float m1 = fmodf(t, 1.0f);
    t = reverse ? 1.0f - m1 : m1;
  } else {
    const float tc = fminf(fmaxf(t, 0.0f), 1.0f);
    t = reverse ? 1.0f - tc : tc;
  }
  const int base_mode = mode % 256;
  if (base_mode == 1) t = sinf(t * 1.57079637f);  // float32(pi / 2)
  if (base_mode == 2) t = t * t;
  return t;
}

// ops/bezier.py:evaluate_at_t of channel c of (4, channels) points.
__device__ __forceinline__ float bezier_channel(const float* points,
                                                int channels, float count,
                                                float t, int c) {
  const int k = channels == 1 ? 0 : c;
  const float a = points[k], b = points[channels + k],
              cc = points[2 * channels + k], d = points[3 * channels + k];
  if (count <= 1.5f) return a;
  const float ab = a + (b - a) * t;
  if (count <= 2.5f) return ab;
  if (count <= 3.5f) return t <= 0.0f ? a : (t >= 1.0f ? cc : b);
  const float bc = b + (cc - b) * t;
  const float cd = cc + (d - cc) * t;
  const float abbc = ab + (bc - ab) * t;
  const float bccd = bc + (cd - bc) * t;
  return abbc + (bccd - abbc) * t;
}

}  // namespace illum_bezier
