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
// tiles run at once. So, with one block per tile and one thread per ray,
// each ray on its own rows of the tile's candidates (mvp_march_common.cuh):
//
//   state   the forward kernel hands over, per ray, the row sums (C_s, a_s) of
//           the row s where the density sum crosses 1 (zeros if it never
//           does) and the final alpha. With a >= 0 the reverse scan of the
//           TPU kernel telescopes: rev_r = w_r - w_sat before row s and 0
//           from it, with w_sat = (g . C_s) / max(a_s, 1e-12) and
//           q_final = [alpha < 1]. The forward is not marched again for it.
//   march   each window of kWindow rows is marched as the forward kernel
//           marches it; the window then holds the row sums, so every row's
//           cscale_r = contrib_r / max(a_r, 1e-12) and
//           dL/da_r = -cscale_r w_r + rev_r + g_a q_final are exact, rows
//           with a_r <= 1e-12 included, and overwrite the row sums in place.
//   chain   for that window, each candidate that meets it is walked again
//           and every live sample's cotangent chained through the template
//           sample (and the warp sample), the fade and the affine
//           y = pos A + b. Each corner's four template channels go to the
//           global gradient table in one 16-byte vector atomic add
//           (red.global.add.v4.f32, new with sm_90), warp channels in scalar
//           atomic adds: the sum over rays, rows and tiles is made there, in
//           L2. (Float adds to shared memory are compare-and-swap loops: a
//           per-candidate box in shared memory took five times as long.)
//           The 12 affine terms are summed in registers, reduced by warp
//           shuffles and added into a per-candidate row in shared memory.
//   drain   the affine rows go out once per tile at the end, with atomicAdd.
//
// Windows after the one where every ray has saturated or passed tmax carry
// no cotangent and are not visited; a sample whose row has cscale = 0 and
// dL/da = 0 (past the ray's saturation row) is skipped. Both are exact.
//
// The sums over rays, rows and tiles are floating-point atomics, so their
// order, and with it the last bits of the result, changes from run to run.
// What bounds it on this card: the instructions of two evaluations of every
// live sample (one for the row sums, one in the chain) plus the chain's 8
// corner reads, 8 vector atomics and fade derivative, at the share of lanes
// that hold a live sample; not device-memory bytes. The vector atomics are
// about a quarter of its time on the flagship scene (H100, PERF.md). No wgmma
// (no matrix product in it), no TMA (scattered 16-byte cells).

#include "mvp_march_common.cuh"

namespace {

using namespace mvp;

// Both by measurement on an H100 (PERF.md): 8-row windows and one or
// three blocks per SM were slower.
constexpr int kWindow = 16;    // step rows per window, WINDOW in ops/raymarch_cuda.py
constexpr int kMinBlocks = 2;  // blocks of 256 threads per SM the registers are capped for

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
// The 8 cell loads come first and are independent; a corner outside the box
// contributes nothing and adds nothing.
template <int C>
__device__ __forceinline__ void trilinear_bwd(const float* __restrict__ vol, float* dvol, int bs,
                                              float fx, float fy, float fz, const float* dS,
                                              float* df) {
  const float lim = (float)(bs - 1);
  const Axis ax = axis_corners(fx, lim), ay = axis_corners(fy, lim), az = axis_corners(fz, lim);
  int off[8];
  float q[8][C];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    off[k] = ((az.i[k >> 2] * bs + ay.i[(k >> 1) & 1]) * bs + ax.i[k & 1]) * C;
    load_cell<C>(vol + off[k], q[k]);
  }
  df[0] = df[1] = df[2] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
    if (!(ax.ok[dx] && ay.ok[dy] && az.ok[dz])) continue;
    const float wx = ax.w[dx], wy = ay.w[dy], wz = az.w[dz];
    const float w = (wx * wy) * wz;
    float dot = 0.0f, add[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dot = dot + q[k][c] * dS[c];
      add[c] = w * dS[c];
    }
    add_cell<C>(dvol + off[k], add);
    df[0] = df[0] + (dx ? dot : -dot) * (wy * wz);
    df[1] = df[1] + (dy ? dot : -dot) * (wx * wz);
    df[2] = df[2] + (dz ? dot : -dot) * (wx * wy);
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
// registers, 1024 caps it at 64 registers and spills. kProbe adds the
// lane-use counters (probe[0..3) the march, probe[3..6) the chain).
template <int kMaxThreads, bool kProbe>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads <= 256 ? kMinBlocks : 1)
mvp_march_bwd_kernel(
    Scene p, const float* g_tiles, const float* state, float* dtmpl, float* dwarp, float* daff,
    unsigned long long* counts, unsigned long long* probe) {
  extern __shared__ float4 smem[];
  const int t2 = blockDim.x;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const int bs = p.bs;
  const int box = bs * bs * bs;
  const int mh = p.mh;
  const Tables tb = carve_tables(smem, kWindow, t2, mh);
  float* caff = reinterpret_cast<float*>(tb.cr1 + mh);  // [mh][12] affine gradient of the tile

  for (int i = tid; i < mh * 12; i += t2) caff[i] = 0.0f;
  const Ray ray = load_ray(p, tile, t2, tid);
  int rmin, rmax;
  load_candidates(p, tile, ray, tb, rmin, rmax);  // ends with a barrier

  const size_t gb = tile * 4 * t2 + tid;
  const float g0 = g_tiles[gb], g1 = g_tiles[gb + t2], g2 = g_tiles[gb + 2 * t2],
              g3 = g_tiles[gb + 3 * t2];
  // the forward's saturation state of this ray
  const size_t sb = tile * 5 * t2 + tid;
  const float a_s = state[sb + 3 * t2];
  const float wsat = a_s > 0.0f
      ? (g0 * state[sb] + g1 * state[sb + t2] + g2 * state[sb + 2 * t2]) / fmaxf(a_s, 1e-12f)
      : 0.0f;
  const float ga_qf = state[sb + 4 * t2] < 1.0f ? g3 : 0.0f;  // g_a * q_final

  const float half = 0.5f * (float)(bs - 1);
  const float cfade = -p.fadescale * p.fadeexp;
  unsigned nfwd = 0, nchain = 0;  // samples blended (the march), chained
  Probe pm, pc;
  float cum = 0.0f;
  for (int w0 = rmin; w0 < rmax; w0 += kWindow) {
    const int w1 = min(w0 + kWindow, rmax);
    march_window<kWindow, kProbe>(p, ray, tb, w0, w1, nfwd, pm);
    // the rows' cotangents: (cscale_r, dL/da_r) over the row sums
    for (int r = w0; r < w1; ++r) {
      const float4 row = tb.acc[(r - w0) * t2 + tid];
      const float a = row.w;
      const float nw = cum + a;
      const float am = fmaxf(a, 1e-12f);
      const float csc = (fminf(nw, 1.0f) - fminf(cum, 1.0f)) / am;
      const float w = (g0 * row.x + g1 * row.y + g2 * row.z) / am;
      const float rev = nw < 1.0f ? w - wsat : 0.0f;
      tb.acc[(r - w0) * t2 + tid] = make_float4(csc, (rev - csc * w) + ga_qf, 0.0f, 0.0f);
      cum = nw;
    }

    // the chain
    for_each_candidate(p, ray, tb, w0, w1, [&](int c, const Slab& s, int lo, int hi) {
      const size_t g = (size_t)tb.cgid[c];
      const float* tbox = p.tmpl + g * box * 4;
      const float* wbox = p.warp ? p.warp + g * box * 3 : nullptr;
      float af[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) af[k] = 0.0f;
      bool touched = false;
      for (int r = lo; r < hi; ++r) {
        const float4 row = tb.acc[(r - w0) * t2 + tid];
        const float csc = row.x, da = row.y;
        if (csc == 0.0f && da == 0.0f) continue;
        Sample sp;
        probe_trip<kProbe>(pc);
        if (!eval_sample(p, ray, s, tbox, wbox, half, r, sp)) continue;
        touched = true;
        ++nchain;
        if constexpr (kProbe) ++pc.useful;
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
        trilinear_bwd<4>(tbox, dtmpl + g * box * 4, bs, sp.f2[0], sp.f2[1], sp.f2[2], dS, df);
        if (wbox) {
          float dsw[3] = {df[0] * half, df[1] * half, df[2] * half};
          trilinear_bwd<3>(wbox, dwarp + g * box * 3, bs, sp.f[0], sp.f[1], sp.f[2], dsw, df);
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
      if (__any_sync(kFull, touched)) {
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          float v = af[k];
#pragma unroll
          for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
          if ((tid & 31) == 0 && v != 0.0f) atomicAdd(caff + c * 12 + k, v);
        }
      }
    });
    if (tile_done(p, ray, cum, w1)) break;
  }

  __syncthreads();
  for (int i = tid; i < mh * 12; i += t2) {
    const float v = caff[i];
    if (v != 0.0f) atomicAdd(daff + (size_t)tb.cgid[i / 12] * 12 + i % 12, v);
  }
  if (counts) {  // the work done, for the caller's roofline
    nfwd = __reduce_add_sync(kFull, nfwd);
    nchain = __reduce_add_sync(kFull, nchain);
    if ((tid & 31) == 0) {
      atomicAdd(counts, (unsigned long long)nfwd);
      atomicAdd(counts + 1, (unsigned long long)nchain);
    }
  }
  if constexpr (kProbe) {
    probe_drain(pm, probe);
    probe_drain(pc, probe + 3);
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one block needs, in bytes.
size_t mvp_march_bwd_smem_bytes(int tsz, int mh) {
  return tables_bytes(kWindow, tsz, mh) + sizeof(float) * 12 * mh;
}

// Launches one block per tile on `stream`, adding into dtmpl, dwarp and daff
// (the caller zeroes them). state [NT, 5, T2] is the forward kernel's second
// output on the same inputs. counts, when not null, gets two sums added: the
// samples blended in the march, and the samples chained. probe (or null)
// selects the counting instance and gets six sums added. Returns
// cudaGetLastError().
int mvp_march_bwd(const int* gid, const float* scal, const float* ray_o, const float* ray_d,
                  const float* ray_mm, const float* g_tiles, const float* state,
                  const float* tmpl, const float* warp, float* dtmpl, float* dwarp, float* daff,
                  unsigned long long* counts, unsigned long long* probe, int ntiles, int tsz,
                  int mh, int bs, int nbuf, float dt, float fadescale, float fadeexp,
                  void* stream) {
  const Scene p = make_scene(gid, scal, ray_o, ray_d, ray_mm, tmpl, warp, mh, bs, nbuf, dt,
                             fadescale, fadeexp);
  const size_t smem = mvp_march_bwd_smem_bytes(tsz, mh);
  auto* kernel = probe ? (tsz <= 256 ? mvp_march_bwd_kernel<256, true>
                                     : mvp_march_bwd_kernel<1024, true>)
                       : (tsz <= 256 ? mvp_march_bwd_kernel<256, false>
                                     : mvp_march_bwd_kernel<1024, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (ntiles > 0) {
    kernel<<<ntiles, tsz, smem, static_cast<cudaStream_t>(stream)>>>(
        p, g_tiles, state, dtmpl, dwarp, daff, counts, probe);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
