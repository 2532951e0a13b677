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
// What bounds it: each sample reads 8 trilinear corners of a 4-channel box
// (plus 8 of a 3-channel warp box) and spends ~100 fp32 operations on the
// slab, fade and blend, so it is bound by operations and by the latency of
// the corner loads, not by device-memory bytes: the template is read once
// per (tile, candidate) through L1/L2 (bs^3 * 16 B = 8 KiB at bs = 8, about
// 1.4 GB at the flagship shape before cache reuse), against billions of
// corner loads that hit in cache.
//
// Design: the TPU kernel keeps an nbuf-row step buffer per tile in VMEM
// (3.5 MiB at nbuf = 896), far above a block's 227 KB of shared memory.
// Here the rows are marched in windows of kWindow rows: for each window,
// every candidate whose tile-coherent row range [r0, r1) meets the window
// adds its samples into a kWindow x 4 x T2 shared buffer, then the window is
// composited and (cum, rgb) carried to the next one. Each thread owns its
// ray's column of the buffer, so the window needs no barrier. A block stops
// once every ray has saturated or can take no further sample (tmax passed);
// later rows cannot change the composite, so the early exit is exact. Rows
// outside a candidate's [r0, r1) are masked for every ray of the tile, so
// skipping them is exact as well. No wgmma/TMA yet: a simple kernel first.
//
// The device code shared with the backward kernel (slab test, fade, trilinear
// sample, row ranges, the march of one window) is in mvp_march_common.cuh.
//
// Build with --fmad=false: the plain PyTorch version in
// ava256_tpu_torch/ops/raymarch_cuda.py runs the same operations in the same
// order as separate, individually rounded kernels, and the two then agree to
// the last few ulps.

#include "mvp_march_common.cuh"

namespace {

using namespace mvp;

__global__ void __launch_bounds__(1024) mvp_march_fwd_kernel(Scene p, float* out) {
  extern __shared__ float smem[];
  const int t2 = blockDim.x;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const int mh = p.mh;
  float* acc = smem;                        // [kWindow][4][t2]
  float* cs = acc + kWindow * 4 * t2;       // [mh][12]
  int* cr0 = reinterpret_cast<int*>(cs + mh * 12);  // [mh]
  int* cr1 = cr0 + mh;                      // [mh]
  int* cgid = cr1 + mh;                     // [mh]

  // Phase 1: the candidates and their tile-coherent step-row ranges.
  const Ray ray = load_ray(p, tile, t2, tid);
  int rmin, rmax;
  load_candidates(p, tile, ray, cs, cr0, cr1, cgid, rmin, rmax);

  // Phase 2: march and composite window by window.
  float cum = 0.0f, rgb0 = 0.0f, rgb1 = 0.0f, rgb2 = 0.0f;
  unsigned nsamp = 0;  // unused here
  for (int w0 = rmin; w0 < rmax; w0 += kWindow) {
    const int w1 = min(w0 + kWindow, rmax);
    march_window(p, ray, cs, cr0, cr1, cgid, acc, w0, w1, nsamp);
    for (int r = w0; r < w1; ++r) {
      const float* row = acc + (r - w0) * 4 * t2 + tid;
      const float a = row[3 * t2];
      const float nw = cum + a;
      const float scale = (fminf(nw, 1.0f) - fminf(cum, 1.0f)) / fmaxf(a, 1e-12f);
      rgb0 = rgb0 + scale * row[0];
      rgb1 = rgb1 + scale * row[t2];
      rgb2 = rgb2 + scale * row[2 * t2];
      cum = nw;
    }
    const bool done = cum >= 1.0f || !(ray.tmin < ray.tmax) ||
                      ray.tmin + (float)w1 * p.dt >= ray.tmax;
    if (__syncthreads_and(done)) break;
  }

  const size_t ob = tile * 4 * t2 + tid;
  out[ob] = rgb0;
  out[ob + t2] = rgb1;
  out[ob + 2 * t2] = rgb2;
  out[ob + 3 * t2] = fminf(cum, 1.0f);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one block needs, in bytes.
size_t mvp_march_fwd_smem_bytes(int tsz, int mh) {
  return sizeof(float) * ((size_t)kWindow * 4 * tsz + (size_t)mh * 12) + sizeof(int) * 3 * mh;
}

// Launches one block per tile on `stream`; returns cudaGetLastError().
int mvp_march_fwd(const int* gid, const float* scal, const float* ray_o, const float* ray_d,
                  const float* ray_mm, const float* tmpl, const float* warp, float* out,
                  int ntiles, int tsz, int mh, int bs, int nbuf, float dt, float fadescale,
                  float fadeexp, void* stream) {
  const Scene p = make_scene(gid, scal, ray_o, ray_d, ray_mm, tmpl, warp, mh, bs, nbuf, dt,
                             fadescale, fadeexp);
  const size_t smem = mvp_march_fwd_smem_bytes(tsz, mh);
  cudaError_t err = cudaFuncSetAttribute(
      mvp_march_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (ntiles > 0) {
    mvp_march_fwd_kernel<<<ntiles, tsz, smem, static_cast<cudaStream_t>(stream)>>>(p, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
