// Copyright (c) ava256_tpu contributors.
// All rights reserved.
//
// This source code is licensed under the license found in the
// LICENSE file in the root directory of this source tree.
//
// Backward MVP raymarch kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel body `_bwd_kernel` of
// ava256_tpu/ops/raymarch_pallas.py (called by `_backward_pallas`): from the
// cotangent of the composited tiles [NT, 4, T2] it computes the gradients of
// the template boxes [N*K, bs, bs, bs, 4], of the warp boxes
// [N*K, bs, bs, bs, 3] (when there is a warp) and of every primitive's
// affine (dA 3x3 row-major, then db) [N*K, 12], the sum over all tiles
// included. Densities are taken to be non-negative, as the forward kernel's
// early exit already takes them.
//
// Design. The TPU kernel rebuilds an nbuf-row step buffer per tile in VMEM,
// scans it forward and in reverse for the per-row cotangents, and re-marches
// every candidate against a second nbuf-row buffer; the tile grid runs in
// sequence, so its read-modify-write of the gradient tables is race free.
// Neither holds here: a block has 227 KB of shared memory, and thousands of
// tiles run at once. So, with one block per tile and one thread per ray:
//
//   pass 1  marches the windows of kWindow rows as the forward kernel does and
//           keeps O(1) state per ray: w_sat = (g . C_s) / max(a_s, 1e-12) at
//           the row s where the density sum crosses 1 (0 if it never does),
//           and q_final = [sum < 1]. With a >= 0 the reverse scan of the TPU
//           kernel telescopes: rev_r = w_r - w_sat before row s and 0 from it.
//   pass 2  marches each window again; the window then holds the row sums, so
//           every row's cscale_r = contrib_r / max(a_r, 1e-12) and
//           dL/da_r = -cscale_r w_r + rev_r + g_a q_final are exact, rows
//           with a_r <= 1e-12 included, and overwrite the row sums in place.
//   pass 3  re-marches, for that window, each candidate that meets it and
//           chains every live sample's cotangent through the template sample
//           (and the warp sample), the fade and the affine y = pos A + b.
//           Each corner's four template channels go to the global gradient
//           table in one 16-byte vector atomic add (red.global.add.v4.f32,
//           new with sm_90), warp channels in scalar atomic adds: the sum over
//           rays, rows and tiles is made there, in L2. (A per-candidate box in
//           shared memory, drained per window, was tried first and took five
//           times as long on the flagship scene: float adds to shared memory
//           are compare-and-swap loops.) The 12 affine terms are
//           summed in registers, reduced by warp shuffles and added into a
//           per-candidate row in shared memory.
//   drain   the affine rows go out once per tile at the end, with atomicAdd.
//
// Windows after the one where every ray has saturated or passed tmax carry
// no cotangent and are not visited; a sample whose row has cscale = 0 and
// dL/da = 0 (past the ray's saturation row) is skipped. Both are exact.
//
// The sums over rays, rows and tiles are floating-point atomics, so their
// order, and with it the last bits of the result, changes from run to run.
// What bounds it: about three forward samples plus one chained sample per
// live sample, each with 8 corner reads and (chained) 8 vector atomics, so
// operations and L2 atomic throughput, not device-memory bytes.

#include "mvp_march_common.cuh"

namespace {

using namespace mvp;

constexpr unsigned kFull = 0xffffffffu;

// Adds v[0..C) into the global gradient table at dst: one vector atomic for
// the 16-byte aligned 4-channel template cells, scalar atomics otherwise.
template <int C>
__device__ __forceinline__ void add_cell(float* dst, const float* v) {
  if constexpr (C == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(dst + c, v[c]);
  }
}

// Gradient of trilinear<C>: adds w * dS into the box's gradient dvol (global
// memory) and returns d/d(fx, fy, fz) of the sample dotted with dS. Weights
// as in the forward: the derivative of a weight pair along an axis is -1 / +1.
template <int C>
__device__ __forceinline__ void trilinear_bwd(const float* __restrict__ vol, float* dvol, int bs,
                                              float fx, float fy, float fz, const float* dS,
                                              float* df) {
  const float x0 = floorf(fx), y0 = floorf(fy), z0 = floorf(fz);
  const float wx1 = fx - x0, wy1 = fy - y0, wz1 = fz - z0;
  const float lim = (float)(bs - 1);
  df[0] = df[1] = df[2] = 0.0f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float zi = z0 + (float)dz;
    if (zi < 0.0f || zi > lim) continue;
    const float wz = dz ? wz1 : 1.0f - wz1;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yi = y0 + (float)dy;
      if (yi < 0.0f || yi > lim) continue;
      const float wy = dy ? wy1 : 1.0f - wy1;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xi = x0 + (float)dx;
        if (xi < 0.0f || xi > lim) continue;
        const float wx = dx ? wx1 : 1.0f - wx1;
        const float w = (wx * wy) * wz;
        const int off = (((int)zi * bs + (int)yi) * bs + (int)xi) * C;
        float dot = 0.0f, add[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dot = dot + __ldg(vol + off + c) * dS[c];
          add[c] = w * dS[c];
        }
        add_cell<C>(dvol + off, add);
        df[0] = df[0] + (dx ? dot : -dot) * (wy * wz);
        df[1] = df[1] + (dy ? dot : -dot) * (wx * wz);
        df[2] = df[2] + (dz ? dot : -dot) * (wx * wy);
      }
    }
  }
}

// |x|^(p-1) * sign(x), the fade's inner derivative.
__device__ __forceinline__ float pow_abs_m1_signed(float x, int p_int, float p) {
  const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  if (p_int == 1) return sgn;
  return pow_abs(x, p_int ? p_int - 1 : 0, p - 1.0f) * sgn;
}

// kMaxThreads bounds the block size the instance is compiled for: 256 (tiles
// of up to 16 x 16 rays) lets the compiler keep the chain's state in
// registers, 1024 caps it at 64 registers and spills.
template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) mvp_march_bwd_kernel(
    Scene p, const float* g_tiles, float* dtmpl, float* dwarp, float* daff,
    unsigned long long* counts) {
  extern __shared__ float smem[];
  const int t2 = blockDim.x;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const int mh = p.mh, bs = p.bs;
  const int box = bs * bs * bs;
  float* acc = smem;                        // [kWindow][4][t2]
  float* cs = acc + kWindow * 4 * t2;       // [mh][12]
  float* caff = cs + mh * 12;               // [mh][12] affine gradient of the tile
  int* cr0 = reinterpret_cast<int*>(caff + mh * 12);  // [mh]
  int* cr1 = cr0 + mh;                      // [mh]
  int* cgid = cr1 + mh;                     // [mh]

  for (int i = tid; i < mh * 12; i += t2) caff[i] = 0.0f;
  const Ray ray = load_ray(p, tile, t2, tid);
  int rmin, rmax;
  load_candidates(p, tile, ray, cs, cr0, cr1, cgid, rmin, rmax);  // ends with a barrier

  const size_t gb = tile * 4 * t2 + tid;
  const float g0 = g_tiles[gb], g1 = g_tiles[gb + t2], g2 = g_tiles[gb + 2 * t2],
              g3 = g_tiles[gb + 3 * t2];

  // Pass 1: the forward march, keeping each ray's saturation state.
  float cum = 0.0f, wsat = 0.0f;
  unsigned nfwd = 0, nchain = 0;  // samples blended (passes 1 and 2), chained (pass 3)
  int w_end = rmax;
  for (int w0 = rmin; w0 < rmax; w0 += kWindow) {
    const int w1 = min(w0 + kWindow, rmax);
    march_window(p, ray, cs, cr0, cr1, cgid, acc, w0, w1, nfwd);
    for (int r = w0; r < w1; ++r) {
      const float* row = acc + (r - w0) * 4 * t2 + tid;
      const float a = row[3 * t2];
      const float nw = cum + a;
      if (cum < 1.0f && nw >= 1.0f) {
        wsat = (g0 * row[0] + g1 * row[t2] + g2 * row[2 * t2]) / fmaxf(a, 1e-12f);
      }
      cum = nw;
    }
    const bool done = cum >= 1.0f || !(ray.tmin < ray.tmax) ||
                      ray.tmin + (float)w1 * p.dt >= ray.tmax;
    if (__syncthreads_and(done)) {
      w_end = w1;
      break;
    }
  }
  const float ga_qf = cum < 1.0f ? g3 : 0.0f;  // g_a * q_final

  // Passes 2 and 3, window by window.
  const float half = 0.5f * (float)(bs - 1);
  const float cfade = -p.fadescale * p.fadeexp;
  cum = 0.0f;
  for (int w0 = rmin; w0 < w_end; w0 += kWindow) {
    const int w1 = min(w0 + kWindow, rmax);
    march_window(p, ray, cs, cr0, cr1, cgid, acc, w0, w1, nfwd);
    for (int r = w0; r < w1; ++r) {
      float* row = acc + (r - w0) * 4 * t2 + tid;
      const float a = row[3 * t2];
      const float nw = cum + a;
      const float am = fmaxf(a, 1e-12f);
      const float csc = (fminf(nw, 1.0f) - fminf(cum, 1.0f)) / am;
      const float w = (g0 * row[0] + g1 * row[t2] + g2 * row[2 * t2]) / am;
      const float rev = nw < 1.0f ? w - wsat : 0.0f;
      row[0] = csc;
      row[t2] = (rev - csc * w) + ga_qf;
      cum = nw;
    }

    for (int c = 0; c < mh; ++c) {
      const int lo = max(max(cr0[c], 0), w0);
      const int hi = min(min(cr1[c], p.nbuf), w1);
      if (lo >= hi) continue;  // uniform across the block
      const Slab s = slab(cs + c * 12, ray);
      const size_t g = (size_t)cgid[c];
      const float* tb = p.tmpl + g * box * 4;
      const float* wb = p.warp ? p.warp + g * box * 3 : nullptr;
      float af[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) af[k] = 0.0f;
      bool touched = false;
      if (s.seg) {
        for (int r = lo; r < hi; ++r) {
          const float* row = acc + (r - w0) * 4 * t2 + tid;
          const float csc = row[0], da = row[t2];
          if (csc == 0.0f && da == 0.0f) continue;
          Sample sp;
          if (!eval_sample(p, ray, s, tb, wb, half, r, sp)) continue;
          touched = true;
          ++nchain;
          const float dl0 = g0 * csc, dl1 = g1 * csc, dl2 = g2 * csc;
          const float rgb_dot = dl0 * sp.sm[0] + dl1 * sp.sm[1] + dl2 * sp.sm[2];
          const float alpha = sp.sm[3];
          float dS[4];
          dS[0] = dl0 * alpha * sp.u;
          dS[1] = dl1 * alpha * sp.u;
          dS[2] = dl2 * alpha * sp.u;
          dS[3] = (da + rgb_dot) * sp.u;
          const float g_u = (da + rgb_dot) * alpha;
          float df[3];
          trilinear_bwd<4>(tb, dtmpl + g * box * 4, bs, sp.f2[0], sp.f2[1], sp.f2[2], dS, df);
          if (wb) {
            float dsw[3] = {df[0] * half, df[1] * half, df[2] * half};
            trilinear_bwd<3>(wb, dwarp + g * box * 3, bs, sp.f[0], sp.f[1], sp.f[2], dsw, df);
          }
          const float dfade = g_u * p.dt;
          float dy[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            dy[j] = df[j] * half +
                    dfade * sp.fade * cfade * pow_abs_m1_signed(sp.y[j], p.fade_int, p.fadeexp);
          }
          const float pos[3] = {ray.ox + ray.dx * sp.t, ray.oy + ray.dy * sp.t,
                                ray.oz + ray.dz * sp.t};
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) af[i * 3 + j] = af[i * 3 + j] + pos[i] * dy[j];
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) af[9 + j] = af[9 + j] + dy[j];
        }
      }
      if (__any_sync(kFull, touched)) {
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          float v = af[k];
#pragma unroll
          for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
          if ((tid & 31) == 0 && v != 0.0f) atomicAdd(caff + c * 12 + k, v);
        }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < mh * 12; i += t2) {
    const float v = caff[i];
    if (v != 0.0f) atomicAdd(daff + (size_t)cgid[i / 12] * 12 + i % 12, v);
  }
  if (counts) {  // the work done, for the caller's roofline
    nfwd = __reduce_add_sync(kFull, nfwd);
    nchain = __reduce_add_sync(kFull, nchain);
    if ((tid & 31) == 0) {
      atomicAdd(counts, (unsigned long long)nfwd);
      atomicAdd(counts + 1, (unsigned long long)nchain);
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one block needs, in bytes.
size_t mvp_march_bwd_smem_bytes(int tsz, int mh) {
  return sizeof(float) * ((size_t)kWindow * 4 * tsz + (size_t)mh * 24) + sizeof(int) * 3 * mh;
}

// Launches one block per tile on `stream`, adding into dtmpl, dwarp and daff
// (the caller zeroes them). counts, when not null, gets two sums added: the
// samples blended in passes 1 and 2, and the samples chained in pass 3.
// Returns cudaGetLastError().
int mvp_march_bwd(const int* gid, const float* scal, const float* ray_o, const float* ray_d,
                  const float* ray_mm, const float* g_tiles, const float* tmpl, const float* warp,
                  float* dtmpl, float* dwarp, float* daff, unsigned long long* counts, int ntiles,
                  int tsz, int mh, int bs, int nbuf, float dt, float fadescale, float fadeexp,
                  void* stream) {
  const Scene p = make_scene(gid, scal, ray_o, ray_d, ray_mm, tmpl, warp, mh, bs, nbuf, dt,
                             fadescale, fadeexp);
  const size_t smem = mvp_march_bwd_smem_bytes(tsz, mh);
  auto* kernel = tsz <= 256 ? mvp_march_bwd_kernel<256> : mvp_march_bwd_kernel<1024>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (ntiles > 0) {
    kernel<<<ntiles, tsz, smem, static_cast<cudaStream_t>(stream)>>>(
        p, g_tiles, dtmpl, dwarp, daff, counts);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
