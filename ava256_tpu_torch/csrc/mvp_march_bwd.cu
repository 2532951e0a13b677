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
//           y = pos A + b. Each corner's template and warp channels go to
//           the global gradient tables as 64-bit integer atomic adds
//           (fixed_point.cuh), one per channel where float sums could add
//           the four template channels as one 16-byte vector; each quad of
//           lanes transposes its four cells' values first, so that one
//           instruction adds whole cells (template_bwd). The sum over
//           rays, rows and tiles is made there, in L2. (Summing each
//           candidate's box in shared memory first, flushed per window,
//           was slower: the block waits at two barriers per candidate.)
//           The 12 affine terms are summed in registers and
//           reduced by warp shuffles (a fixed tree); the warp's lane 0 adds
//           them into the warp's own row of the candidate in global memory
//           (daff_rows [NT, warps, MH, 12], no other thread writes it), so
//           no atomics. The caller sums the rows over warps and, as int64 at
//           a scale set by their exact sum of |values|, over tiles.
//
// Windows after the one where every ray has saturated or passed tmax carry
// no cotangent and are not visited; a sample whose row has cscale = 0 and
// dL/da = 0 (past the ray's saturation row) is skipped. Both are exact.
//
// Determinism. Every sum across threads is an integer sum or has one owner,
// so two runs on the same inputs give the same bits, as the TPU kernel's
// sequential tile grid does. The box tables are int64 in units of 2^-k; a
// second pass (fxp::to_float) turns them into the float32 gradients. k is
// chosen per call and per channel group (the template's four channels, the
// warp) from a sound bound B of the sum of |addends| the group can receive,
// 2^k = 2^floor(61 - log2 B) (ops/raymarch_cuda.py fixed_point_bounds): no
// partial sum can leave int64. The bound follows from the densities being
// non-negative: per ray, the samples' cscale_r * alpha * u sum to at most 1
// (the composite's weights), cscale_r <= 1, |w|, |wsat| and |rgb_dot| are at
// most sum_c |g_c| * max|rgb|, and a ray's samples of a box lie on its chord
// through the box, one per dt. Resolution: an addend is off by at
// most 2^-(k+1) = B * 2^-62, so a gradient whose largest value M lies b
// bits below B keeps about 62 - b bits of M less the bits of its addend
// count; chip_smoke.py prints b for each group on the flagship and 262k
// scenes ([flagship-kernel-bwd] headroom_bits), and the kernel is held to
// the plain version at 2e-5 of M there. (The affine's bound would be looser
// by the ray positions and the chain's products: it is summed from its
// exact per-tile rows instead.) A negative density (the bound's
// premise) or an addend that still reaches 2^62 sets a device flag that the
// training loop reads with the loss and raises on; it is never zeroed or
// hidden.
//
// What bounds it on this card: the instructions of two evaluations of every
// live sample (one for the row sums, one in the chain) plus the chain's 8
// corner reads, the 8 x 4 integer atomics of the template (issued by quads
// of lanes, a whole 32-byte cell per lane group; see template_bwd) and 8 x 3
// of a warp, and the fade derivative, at the share of lanes that hold a
// live sample; not device-memory bytes. No wgmma (no matrix product in it),
// no TMA (scattered cells).

#include "fixed_point.cuh"
#include "mvp_march_common.cuh"

namespace {

using namespace mvp;

// Both by measurement on an H100 (PERF.md): 8-row windows and one or
// three blocks per SM were slower.
constexpr int kWindow = 16;    // step rows per window, WINDOW in ops/raymarch_cuda.py
constexpr int kMinBlocks = 2;  // blocks of 256 threads per SM the registers are capped for

// Per-call fixed-point scales (2^k, see the header): the template's four
// channels, then the warp's three.
struct Scales {
  float tmpl[4], warp;
};

// Adds v[0..C) into the global integer gradient table at dst, channel c at
// scale sc[c].
template <int C>
__device__ __forceinline__ void add_cell(unsigned long long* dst, const float* v,
                                         const float* sc, unsigned* flag) {
#pragma unroll
  for (int c = 0; c < C; ++c) fxp::add(dst + c, v[c], sc[c], flag);
}

// Gradient of trilinear<C>: adds w * dS into the box's integer gradient dvol
// (global memory) and returns d/d(fx, fy, fz) of the sample dotted with dS. Weights
// as in the forward: the derivative of a weight pair along an axis is -1 / +1.
// The 8 cell loads come first and are independent; a corner outside the box
// contributes nothing and adds nothing.
template <int C>
__device__ __forceinline__ void trilinear_bwd(const float* __restrict__ vol,
                                              unsigned long long* dvol, int bs, float fx,
                                              float fy, float fz, const float* dS, float* df,
                                              const float* sc, unsigned* flag) {
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
    add_cell<C>(dvol + off[k], add, sc, flag);
    df[0] = df[0] + (dx ? dot : -dot) * (wy * wz);
    df[1] = df[1] + (dy ? dot : -dot) * (wx * wz);
    df[2] = df[2] + (dz ? dot : -dot) * (wx * wy);
  }
}

// The 4 x 4 transpose within each quad of lanes: lane j of a quad gets
// channel j of the four lanes' values, v[r] = lane r's v[j] (two butterfly
// stages of two shuffles each).
__device__ __forceinline__ void quad_transpose(float* v) {
  const int j = threadIdx.x & 3;
  const bool b1 = j & 2, b0 = j & 1;
  float s0 = b1 ? v[0] : v[2], s1 = b1 ? v[1] : v[3];
  float r0 = __shfl_xor_sync(kFull, s0, 2), r1 = __shfl_xor_sync(kFull, s1, 2);
  const float p0 = b1 ? r0 : v[0], p1 = b1 ? r1 : v[1], p2 = b1 ? v[2] : r0,
              p3 = b1 ? v[3] : r1;
  s0 = b0 ? p0 : p1;
  s1 = b0 ? p2 : p3;
  r0 = __shfl_xor_sync(kFull, s0, 1);
  r1 = __shfl_xor_sync(kFull, s1, 1);
  v[0] = b0 ? r0 : p0;
  v[1] = b0 ? p1 : r0;
  v[2] = b0 ? r1 : p2;
  v[3] = b0 ? p3 : r1;
}

// trilinear_bwd<4> for the RGBA template, called by every lane of the warp
// (live or not: a lane that is not adds zeros). The adds are coalesced: for
// each corner the quad's four cells are transposed so that lane j adds
// channel j of each, and one instruction adds whole 32-byte cells, eight per
// warp, where adds into each lane's own cell take a sector per lane; on an
// H100 the former is the faster (PERF.md). scale_j: channel j's scale.
__device__ __forceinline__ void template_bwd(const float* __restrict__ vol,
                                             unsigned long long* dvol, int bs, const float* f,
                                             const float* dS, float* df, bool live,
                                             float scale_j, unsigned* flag) {
  const float lim = (float)(bs - 1);
  const Axis ax = axis_corners(f[0], lim), ay = axis_corners(f[1], lim),
             az = axis_corners(f[2], lim);
  const int j = threadIdx.x & 3, quad = (threadIdx.x & 31) & ~3;
  int off[8];
  float q[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    off[k] = ((az.i[k >> 2] * bs + ay.i[(k >> 1) & 1]) * bs + ax.i[k & 1]) * 4;
    if (live) load_cell<4>(vol + off[k], q[k]);
  }
  df[0] = df[1] = df[2] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
    const bool ok = live && ax.ok[dx] && ay.ok[dy] && az.ok[dz];
    float add[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (ok) {
      const float wx = ax.w[dx], wy = ay.w[dy], wz = az.w[dz];
      const float w = (wx * wy) * wz;
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dot = dot + q[k][c] * dS[c];
        add[c] = w * dS[c];
      }
      df[0] = df[0] + (dx ? dot : -dot) * (wy * wz);
      df[1] = df[1] + (dy ? dot : -dot) * (wx * wz);
      df[2] = df[2] + (dz ? dot : -dot) * (wx * wy);
    }
    quad_transpose(add);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int o = __shfl_sync(kFull, off[k], quad | r);
      fxp::add(dvol + o + j, add[r], scale_j, flag);
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
// registers, 1024 caps it at 64 registers and spills. kProbe adds the
// lane-use counters (probe[0..3) the march, probe[3..6) the chain).
template <int kMaxThreads, bool kProbe>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads <= 256 ? kMinBlocks : 1)
mvp_march_bwd_kernel(
    Scene p, const float* g_tiles, const float* state, unsigned long long* dtmpl,
    unsigned long long* dwarp, float* daff_rows, const float* scales, unsigned* flag,
    unsigned long long* counts, unsigned long long* probe) {
  extern __shared__ float4 smem[];
  const int t2 = blockDim.x;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const int bs = p.bs;
  const int box = bs * bs * bs;
  const int mh = p.mh;
  const Tables tb = carve_tables(smem, kWindow, t2, mh);
  // this warp's affine rows [mh][12] of the tile: lane 0 alone writes them
  float* aff = daff_rows + ((tile * (t2 / 32) + tid / 32) * mh) * 12;
  Scales sc;
#pragma unroll
  for (int c = 0; c < 4; ++c) sc.tmpl[c] = scales[c];
  sc.warp = scales[4];
  const float wsc[3] = {sc.warp, sc.warp, sc.warp};
  const int chan = tid & 3;  // the template channel this lane adds (template_bwd)
  const float scale_j = chan == 0 ? sc.tmpl[0] : chan == 1 ? sc.tmpl[1]
                      : chan == 2 ? sc.tmpl[2] : sc.tmpl[3];

  const Ray ray = load_ray(p, tile, t2, tid);
  int rmin, rmax;
  load_candidates(p, tile, ray, tb, rmin, rmax);  // ends with a barrier

  const size_t gb = tile * 4 * t2 + tid;
  const float g0 = g_tiles[gb], g1 = g_tiles[gb + t2], g2 = g_tiles[gb + 2 * t2],
              g3 = g_tiles[gb + 3 * t2];
  // the forward's saturation state of this ray
  const size_t sb = tile * kStateRows * t2 + tid;
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
      unsigned long long* tdst = dtmpl + g * box * 4;
      unsigned long long* wdst = wbox ? dwarp + g * box * 3 : nullptr;
      float af[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) af[k] = 0.0f;
      bool touched = false;
      // every lane takes the warp's largest trip count, so that the quads
      // are whole at template_bwd's shuffles; a lane past its rows is idle
      const int mine = hi > lo ? hi - lo : 0;
      const int trips = __reduce_max_sync(kFull, mine);
      for (int it = 0; it < trips; ++it) {
        const int r = lo + it;
        Sample sp;
        bool live = false;
        float csc = 0.0f, da = 0.0f;
        if (it < mine) {
          const float4 row = tb.acc[(r - w0) * t2 + tid];
          csc = row.x, da = row.y;
          if (csc != 0.0f || da != 0.0f) {
            probe_trip<kProbe>(pc);
            live = eval_sample(p, ray, s, tbox, wbox, half, r, sp);
          }
        }
        if (!__any_sync(kFull, live)) continue;
        float dS[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float g_u = 0.0f;
        if (live) {
          touched = true;
          ++nchain;
          if constexpr (kProbe) ++pc.useful;
          const float dl0 = g0 * csc, dl1 = g1 * csc, dl2 = g2 * csc;
          const float rgb_dot = dl0 * sp.sm[0] + dl1 * sp.sm[1] + dl2 * sp.sm[2];
          const float alpha = sp.sm[3];
          dS[0] = dl0 * alpha * sp.u;
          dS[1] = dl1 * alpha * sp.u;
          dS[2] = dl2 * alpha * sp.u;
          dS[3] = (da + rgb_dot) * sp.u;
          g_u = (da + rgb_dot) * alpha;
        } else {
          sp.f2[0] = sp.f2[1] = sp.f2[2] = 0.0f;  // a cell in the box: nothing is read
        }
        float df[3];
        template_bwd(tbox, tdst, bs, sp.f2, dS, df, live, scale_j, flag);
        if (!live) continue;
        if (wbox) {
          float dsw[3] = {df[0] * half, df[1] * half, df[2] * half};
          trilinear_bwd<3>(wbox, wdst, bs, sp.f[0], sp.f[1], sp.f[2], dsw, df, wsc, flag);
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
          if ((tid & 31) == 0 && v != 0.0f) aff[c * 12 + k] = aff[c * 12 + k] + v;
        }
      }
    });
    if (tile_done(p, ray, cum, w1)) break;
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
size_t mvp_march_bwd_smem_bytes(int tsz, int mh) { return tables_bytes(kWindow, tsz, mh); }

// Launches one block per tile on `stream`, adding into the integer tables
// qtmpl and qwarp (the caller zeroes them) at scales[0..5) (see Scales),
// then turns them into the float32 gradients dtmpl and dwarp with inv_tmpl
// (4, the template's channels) and inv_warp (3); adds each warp's affine
// terms into its rows of daff_rows [NT, tsz / 32, mh, 12] (zeroed by the
// caller). flag gets bit 0 set where an addend could not be added (see
// fixed_point.cuh). state [NT, 8, T2] is the forward kernel's second output
// on the same inputs. counts, when not null, gets two sums
// added: the samples blended in the march, and the samples chained. probe
// (or null) selects the counting instance and gets six sums added. Returns
// the first CUDA error of the launches.
int mvp_march_bwd(const int* gid, const float* scal, const float* ray_o, const float* ray_d,
                  const float* ray_mm, const float* g_tiles, const float* state,
                  const float* tmpl, const float* warp, long long* qtmpl, long long* qwarp,
                  const float* scales, const float* inv_tmpl, const float* inv_warp,
                  float* dtmpl, float* dwarp, float* daff_rows, unsigned* flag,
                  unsigned long long* counts,
                  unsigned long long* probe, int nboxes, int ntiles, int tsz, int mh, int bs,
                  int nbuf, float dt, float fadescale, float fadeexp, void* stream) {
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qt = reinterpret_cast<unsigned long long*>(qtmpl);
  auto* qw = reinterpret_cast<unsigned long long*>(qwarp);
  if (ntiles > 0) {
    kernel<<<ntiles, tsz, smem, st>>>(p, g_tiles, state, qt, qw, daff_rows, scales, flag, counts,
                                      probe);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t cells = (size_t)nboxes * bs * bs * bs;
  if ((err = fxp::launch_to_float<4>(qtmpl, dtmpl, cells * 4, inv_tmpl, st)) != cudaSuccess)
    return (int)err;
  if (!warp) return (int)cudaSuccess;
  return (int)fxp::launch_to_float<3>(qwarp, dwarp, cells * 3, inv_warp, st);
}

}  // extern "C"
