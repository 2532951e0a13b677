// Copyright (c) ava256_tpu contributors.
// All rights reserved.
//
// This source code is licensed under the license found in the
// LICENSE file in the root directory of this source tree.
//
// Order-free sums for the backward kernels (mvp_march_bwd.cu,
// grid_sample.cu): every addend is scaled by a power of two 2^k, rounded to
// the nearest int64 (ties to even) and added with a 64-bit integer atomic.
// Integer addition is associative, so the sum has the same bits whatever
// order the scheduler gives the atomics; a second pass turns the table back
// into float32 (nearest, then times 2^-k, exact).
//
// The scale is chosen per call by the caller (ops/fixed_point.py) from a
// sound bound B of the sum of |addends| that one table can receive:
// 2^k = 2^floor(61 - log2 B), so that no partial sum can pass 2^61 < 2^63.
// An addend is off by at most 2^-(k+1) after rounding. A non-finite bound
// gives a NaN scale: every addend is then skipped and the table reads NaN,
// as a float sum would. An addend whose scaled value is not below 2^62 in
// magnitude (the bound's premises broken, or a non-finite addend under a
// finite scale) is not added: it sets bit 0 of *flag, which the caller
// raises on (ops/raymarch_cuda.check_fixed_point).
//
// For a caller that computes its bound on the device (grid_sample.cu):
// scale_for, the same rule as ops/fixed_point.scale_for, exact by frexp;
// zero_table and to_float take an optional device count that predicates
// them (nothing to do when it is 0), so that a fallback route can sit in
// the stream behind the route that usually does the work and cost a few
// idle blocks when it is not needed.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fxp {

constexpr float kLimit = 4611686018427387904.0f;  // 2^62

// Adds v * scale, rounded, into *dst. Zero addends add nothing.
__device__ __forceinline__ void add(unsigned long long* dst, float v, float scale,
                                    unsigned* flag) {
  const float x = v * scale;
  if (x == 0.0f || scale != scale) return;
  if (!(fabsf(x) < kLimit)) {
    atomicOr(flag, 1u);
    return;
  }
  atomicAdd(dst, static_cast<unsigned long long>(__float2ll_rn(x)));
}

// out[i] = float(q[i]) * inv_scale[i % Period]: the table back in float32;
// nothing when count is given and *count is 0.
template <int Period>
__global__ void to_float(const long long* __restrict__ q, float* __restrict__ out, size_t n,
                         const float* __restrict__ inv_scale, const int* count) {
  if (count && *count == 0) return;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = __ll2float_rn(q[i]) * inv_scale[i % Period];
  }
}

template <int Period>
inline cudaError_t launch_to_float(const long long* q, float* out, size_t n,
                                   const float* inv_scale, cudaStream_t stream,
                                   const int* count = nullptr, size_t max_blocks = 65535 * 8) {
  if (n == 0) return cudaSuccess;
  const size_t blocks = (n + 255) / 256;
  to_float<Period><<<(unsigned)(blocks < max_blocks ? blocks : max_blocks), 256, 0, stream>>>(
      q, out, n, inv_scale, count);
  return cudaGetLastError();
}

// 2^k with k = clamp(floor(61 - log2 bound), -126, 126), computed exactly:
// bound = m 2^e with m in [0.5, 1), so log2 bound = e - 1 when m = 0.5 and
// lies in (e - 1, e) otherwise. NaN for a bound that is not finite.
__device__ __forceinline__ float scale_for(double bound) {
  if (!isfinite(bound) || bound < 0.0) return __int_as_float(0x7fc00000);
  int k = 126;  // log2 0 = -inf
  if (bound > 0.0) {
    int e;
    const double m = frexp(bound, &e);
    k = min(126, max(-126, (m == 0.5 ? 62 : 61) - e));
  }
  return ldexpf(1.0f, k);
}

// q[i] = 0 for i < n, unless count is given and *count is 0.
__global__ void zero_table(long long* __restrict__ q, long long n, const int* count) {
  if (count && *count == 0) return;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    q[i] = 0;
  }
}

}  // namespace fxp
