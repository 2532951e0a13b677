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

// out[i] = float(q[i]) * inv_scale[i % period]: the table back in float32.
__global__ void to_float(const long long* __restrict__ q, float* __restrict__ out, size_t n,
                         const float* __restrict__ inv_scale, int period) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = __ll2float_rn(q[i]) * inv_scale[i % period];
  }
}

inline cudaError_t launch_to_float(const long long* q, float* out, size_t n,
                                   const float* inv_scale, int period, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const size_t blocks = (n + 255) / 256;
  to_float<<<(unsigned)(blocks < 65535 * 8 ? blocks : 65535 * 8), 256, 0, stream>>>(
      q, out, n, inv_scale, period);
  return cudaGetLastError();
}

}  // namespace fxp
