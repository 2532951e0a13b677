// Copyright (c) ava256_tpu contributors.
// All rights reserved.
//
// This source code is licensed under the license found in the
// LICENSE file in the root directory of this source tree.
//
// Forward MVP raymarch kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel body `_fwd_kernel` of
// ava256_tpu/ops/raymarch_pallas.py, which both `_forward_pallas` (candidate
// boxes gathered ahead of the kernel) and `_forward_pallas_dma` (boxes
// fetched by gid from the flat table) call. One block marches one tile of
// rays (one thread per ray) through the tile's depth-sorted candidate
// primitives: every step row sums rgb*alpha*dt*fade and alpha*dt*fade over
// the candidates in candidate order, then the rows are composited front to
// back with saturation (summed-within-step semantics).
//
// What bounds it on this card: not device-memory bytes (the template is read
// once per (tile, candidate) through L1/L2, 8 KiB a box at bs = 8) and not
// the fp32 rate, but the instructions and dependent L1/L2 corner loads each
// sample costs, times the share of a warp's lanes that hold a live sample;
// see mvp_march_common.cuh for what the design does about it (own rows per
// ray, a branch-free sample with 8 independent 16-byte loads, float4 row
// sums, the default fade power in line).
//
// Design: the TPU kernel keeps an nbuf-row step buffer per tile in VMEM
// (3.5 MiB at nbuf = 896), far above a block's 227 KB of shared memory.
// Here the rows are marched in windows of kWindow rows: for each window,
// every candidate whose tile-coherent row range meets the window adds its
// samples into a kWindow x T2 float4 shared buffer, then the window is
// composited and (cum, rgb) carried to the next one. Each thread owns its
// ray's column of the buffer, so the window needs no barrier. A block stops
// once every ray has saturated or can take no further sample (tmax passed);
// later rows cannot change the composite, so the early exit is exact. The
// kernel can also write each ray's saturation state for the backward
// kernel, which then does not march the forward again: the row sums
// (rgb, a) of the row where the density sum crosses 1 (zeros if it never
// does), the final alpha, and the extremes of the template cells the ray's
// samples read (max |rgb|, max |alpha|, min(0, alpha)), over which the
// backward takes the bound of its fixed-point scale: a cell no sample reads
// cannot reach it.
//
// No wgmma (a gather and a trilinear blend, not a matrix product) and no TMA
// (8 scattered cells per sample, served by L1/L2).
//
// Build with --fmad=false: the plain PyTorch version in
// ava256_tpu_torch/ops/raymarch_cuda.py runs the same operations in the same
// order as separate, individually rounded kernels, and the two then agree to
// the last few ulps.

#include "mvp_march_common.cuh"

namespace {

using namespace mvp;

// Both by measurement on an H100 (PERF.md): 8- and 4-row windows were
// slower.
constexpr int kWindow = 16;    // step rows per window, WINDOW in ops/raymarch_cuda.py
constexpr int kMinBlocks = 3;  // blocks of 256 threads per SM the registers are capped for

// kMaxThreads bounds the block size the instance is compiled for; kProbe
// adds the lane-use counters (probe[0..3): warp trips, lanes, samples);
// kState writes each ray's state, the extremes of the template cells its
// samples read included (the instance a training step runs).
template <int kMaxThreads, bool kProbe, bool kState>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads <= 256 ? kMinBlocks : 1)
mvp_march_fwd_kernel(
    Scene p, float* out, float* state, unsigned long long* probe) {
  extern __shared__ float4 smem[];
  const int t2 = blockDim.x;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const Tables tb = carve_tables(smem, kWindow, t2, p.mh);

  // Phase 1: the candidates and their tile-coherent step-row ranges.
  const Ray ray = load_ray(p, tile, t2, tid);
  int rmin, rmax;
  load_candidates(p, tile, ray, tb, rmin, rmax);

  // Phase 2: march and composite window by window.
  float cum = 0.0f, rgb0 = 0.0f, rgb1 = 0.0f, rgb2 = 0.0f;
  float4 sat = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // row sums of the saturation row
  ReadExtremes rd;
  unsigned nsamp = 0;
  Probe pr;
  for (int w0 = rmin; w0 < rmax; w0 += kWindow) {
    const int w1 = min(w0 + kWindow, rmax);
    march_window<kWindow, kProbe, kState>(p, ray, tb, w0, w1, nsamp, pr, &rd);
    for (int r = w0; r < w1; ++r) {
      const float4 row = tb.acc[(r - w0) * t2 + tid];
      const float a = row.w;
      const float nw = cum + a;
      const float scale = (fminf(nw, 1.0f) - fminf(cum, 1.0f)) / fmaxf(a, 1e-12f);
      rgb0 = rgb0 + scale * row.x;
      rgb1 = rgb1 + scale * row.y;
      rgb2 = rgb2 + scale * row.z;
      if (cum < 1.0f && nw >= 1.0f) sat = row;
      cum = nw;
    }
    if (tile_done(p, ray, cum, w1)) break;
  }

  const float alpha = fminf(cum, 1.0f);
  const size_t ob = tile * 4 * t2 + tid;
  out[ob] = rgb0;
  out[ob + t2] = rgb1;
  out[ob + 2 * t2] = rgb2;
  out[ob + 3 * t2] = alpha;
  if constexpr (kState) {
    const size_t sb = tile * kStateRows * t2 + tid;
    state[sb] = sat.x;
    state[sb + t2] = sat.y;
    state[sb + 2 * t2] = sat.z;
    state[sb + 3 * t2] = sat.w;
    state[sb + 4 * t2] = alpha;
    state[sb + 5 * t2] = rd.rgb;
    state[sb + 6 * t2] = rd.alpha;
    state[sb + 7 * t2] = rd.neg;
  }
  if constexpr (kProbe) probe_drain(pr, probe);
}

using Kernel = void (*)(Scene, float*, float*, unsigned long long*);

template <bool kProbe, bool kState>
Kernel pick(int tsz) {
  return tsz <= 256 ? mvp_march_fwd_kernel<256, kProbe, kState>
                    : mvp_march_fwd_kernel<1024, kProbe, kState>;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one block needs, in bytes.
size_t mvp_march_fwd_smem_bytes(int tsz, int mh) { return tables_bytes(kWindow, tsz, mh); }

// Launches one block per tile on `stream`; returns cudaGetLastError().
// state [NT, 8, T2] (or null) gets each ray's saturation state and the
// extremes of the template cells its samples read. probe (or null) selects
// the counting instance and gets three sums added.
int mvp_march_fwd(const int* gid, const float* scal, const float* ray_o, const float* ray_d,
                  const float* ray_mm, const float* tmpl, const float* warp, float* out,
                  float* state, unsigned long long* probe, int ntiles, int tsz, int mh, int bs,
                  int nbuf, float dt, float fadescale, float fadeexp, void* stream) {
  const Scene p = make_scene(gid, scal, ray_o, ray_d, ray_mm, tmpl, warp, mh, bs, nbuf, dt,
                             fadescale, fadeexp);
  const size_t smem = tables_bytes(kWindow, tsz, mh);
  const Kernel kernel = probe ? (state ? pick<true, true>(tsz) : pick<true, false>(tsz))
                              : (state ? pick<false, true>(tsz) : pick<false, false>(tsz));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (ntiles > 0) {
    kernel<<<ntiles, tsz, smem, static_cast<cudaStream_t>(stream)>>>(p, out, state, probe);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
