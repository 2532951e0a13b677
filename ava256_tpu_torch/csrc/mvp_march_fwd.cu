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
// Build with --fmad=false: the plain PyTorch version in
// ava256_tpu_torch/ops/raymarch_cuda.py runs the same operations in the same
// order as separate, individually rounded kernels, and the two then agree to
// the last few ulps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWindow = 16;  // step rows per shared-memory window

struct Params {
  const int* gid;       // [NT, MH] flat primitive index (n * K + k)
  const float* scal;    // [NT, MH, 12] affine A (row-major 3x3) then b
  const float* ray_o;   // [NT, 3, T2]
  const float* ray_d;   // [NT, 3, T2]
  const float* ray_mm;  // [NT, 2, T2] tmin, tmax (tmax clamped to nbuf rows)
  const float* tmpl;    // [N*K, bs, bs, bs, 4] channels-last RGBA boxes
  const float* warp;    // [N*K, bs, bs, bs, 3] or nullptr
  float* out;           // [NT, 4, T2]
  int mh, bs, nbuf, fade_int;
  float dt, fadescale, fadeexp;
};

struct Slab {
  float o[3], d[3], tin, tout;
  bool seg;
};

// Local ray of one candidate and its slab interval clipped to [tmin, tmax)
// (raymarch_pallas.py _prim_setup).
__device__ __forceinline__ Slab slab(const float* s, float ox, float oy, float oz,
                                     float dx, float dy, float dz, float tmin,
                                     float tmax) {
  Slab r;
  float lo[3], hi[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.o[j] = ox * s[j] + oy * s[3 + j] + oz * s[6 + j] + s[9 + j];
    r.d[j] = dx * s[j] + dy * s[3 + j] + dz * s[6 + j];
    float dc = r.d[j];
    if (fabsf(dc) < 1e-9f) dc = dc >= 0.0f ? 1e-9f : -1e-9f;
    const float t1 = (-1.0f - r.o[j]) / dc;
    const float t2 = (1.0f - r.o[j]) / dc;
    lo[j] = fminf(t1, t2);
    hi[j] = fmaxf(t1, t2);
  }
  r.tin = fmaxf(fmaxf(fmaxf(lo[0], lo[1]), lo[2]), tmin);
  r.tout = fminf(fminf(fminf(hi[0], hi[1]), hi[2]), tmax);
  r.seg = r.tin < r.tout;
  return r;
}

// |x|^p by repeated squaring for integer p in [1, 16] (as _pow_abs does),
// powf otherwise.
__device__ __forceinline__ float pow_abs(float x, int p_int, float p) {
  const float a = fabsf(x);
  if (p_int == 0) return powf(a, p);
  float out = 0.0f, acc = a;
  bool have = false;
  for (int n = p_int; n; n >>= 1) {
    if (n & 1) {
      out = have ? out * acc : acc;
      have = true;
    }
    acc = acc * acc;
  }
  return out;
}

// Align-corners trilinear sample of a channels-last [bs, bs, bs, C] box at
// cell coordinates (fx, fy, fz); corners outside the box read zero.
template <int C>
__device__ __forceinline__ void trilinear(const float* __restrict__ vol, int bs, float fx,
                                          float fy, float fz, float* s) {
  const float x0 = floorf(fx), y0 = floorf(fy), z0 = floorf(fz);
  const float wx1 = fx - x0, wy1 = fy - y0, wz1 = fz - z0;
  const float lim = (float)(bs - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.0f;
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
        const float* v = vol + (((int)zi * bs + (int)yi) * bs + (int)xi) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) s[c] = s[c] + __ldg(v + c) * w;
      }
    }
  }
}

__global__ void __launch_bounds__(1024) mvp_march_fwd_kernel(Params p) {
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

  for (int i = tid; i < mh * 12; i += t2) cs[i] = p.scal[tile * mh * 12 + i];
  for (int i = tid; i < mh; i += t2) {
    cgid[i] = p.gid[tile * mh + i];
    cr0[i] = p.nbuf;
    cr1[i] = 0;
  }
  __syncthreads();

  const size_t rb = tile * 3 * t2 + tid;
  const float ox = p.ray_o[rb], oy = p.ray_o[rb + t2], oz = p.ray_o[rb + 2 * t2];
  const float dx = p.ray_d[rb], dy = p.ray_d[rb + t2], dz = p.ray_d[rb + 2 * t2];
  const size_t mb = tile * 2 * t2 + tid;
  const float tmin = p.ray_mm[mb], tmax = p.ray_mm[mb + t2];

  // Phase 1: each candidate's tile-coherent step-row range [r0, r1), with the
  // one-row margins of _prim_setup.
  for (int c = 0; c < mh; ++c) {
    const Slab s = slab(cs + c * 12, ox, oy, oz, dx, dy, dz, tmin, tmax);
    const float lo = s.seg ? floorf((s.tin - tmin) / p.dt) - 1.0f : (float)p.nbuf;
    const float hi = s.seg ? ceilf((s.tout - tmin) / p.dt) + 1.0f : 0.0f;
    int loi = (int)fminf(fmaxf(lo, -1.0f), (float)p.nbuf);
    int hii = (int)fminf(fmaxf(hi, 0.0f), (float)p.nbuf + 1.0f);
    loi = __reduce_min_sync(0xffffffffu, loi);
    hii = __reduce_max_sync(0xffffffffu, hii);
    if ((tid & 31) == 0) {
      atomicMin(cr0 + c, loi);
      atomicMax(cr1 + c, hii);
    }
  }
  __syncthreads();
  int rmin = p.nbuf, rmax = 0;
  for (int c = 0; c < mh; ++c) {
    const int r0 = max(cr0[c], 0), r1 = min(cr1[c], p.nbuf);
    if (r1 > r0) {
      rmin = min(rmin, r0);
      rmax = max(rmax, r1);
    }
  }

  // Phase 2: march and composite window by window.
  const int bs = p.bs;
  const size_t box = (size_t)bs * bs * bs;
  const float half = 0.5f * (float)(bs - 1);
  const float neg_fs = -p.fadescale;
  float cum = 0.0f, rgb0 = 0.0f, rgb1 = 0.0f, rgb2 = 0.0f;
  for (int w0 = rmin; w0 < rmax; w0 += kWindow) {
    const int w1 = min(w0 + kWindow, rmax);
    for (int i = 0; i < kWindow * 4; ++i) acc[i * t2 + tid] = 0.0f;
    for (int c = 0; c < mh; ++c) {
      const int lo = max(max(cr0[c], 0), w0);
      const int hi = min(min(cr1[c], p.nbuf), w1);
      if (lo >= hi) continue;  // uniform across the block
      const Slab s = slab(cs + c * 12, ox, oy, oz, dx, dy, dz, tmin, tmax);
      if (!s.seg) continue;
      const size_t g = (size_t)cgid[c];
      const float* tb = p.tmpl + g * box * 4;
      const float* wb = p.warp ? p.warp + g * box * 3 : nullptr;
      for (int r = lo; r < hi; ++r) {
        const float t = tmin + (float)r * p.dt;
        const float y0 = s.o[0] + t * s.d[0];
        const float y1 = s.o[1] + t * s.d[1];
        const float y2 = s.o[2] + t * s.d[2];
        const bool inbox = y0 >= -1.0f && y0 <= 1.0f && y1 >= -1.0f && y1 <= 1.0f &&
                           y2 >= -1.0f && y2 <= 1.0f;
        if (!(inbox && t >= s.tin && t < s.tout && t >= tmin && t < tmax)) continue;
        const float fade = expf(
            neg_fs * (pow_abs(y0, p.fade_int, p.fadeexp) + pow_abs(y1, p.fade_int, p.fadeexp) +
                      pow_abs(y2, p.fade_int, p.fadeexp)));
        const float u = fade * p.dt;
        float fx = (y0 + 1.0f) * half, fy = (y1 + 1.0f) * half, fz = (y2 + 1.0f) * half;
        if (wb) {
          float sw[3];
          trilinear<3>(wb, bs, fx, fy, fz, sw);
          fx = (sw[0] + 1.0f) * half;
          fy = (sw[1] + 1.0f) * half;
          fz = (sw[2] + 1.0f) * half;
        }
        float sm[4];
        trilinear<4>(tb, bs, fx, fy, fz, sm);
        const float a = sm[3] * u;
        float* row = acc + (r - w0) * 4 * t2 + tid;
        row[0] = row[0] + sm[0] * a;
        row[t2] = row[t2] + sm[1] * a;
        row[2 * t2] = row[2 * t2] + sm[2] * a;
        row[3 * t2] = row[3 * t2] + a;
      }
    }
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
    const bool done = cum >= 1.0f || !(tmin < tmax) || tmin + (float)w1 * p.dt >= tmax;
    if (__syncthreads_and(done)) break;
  }

  const size_t ob = tile * 4 * t2 + tid;
  p.out[ob] = rgb0;
  p.out[ob + t2] = rgb1;
  p.out[ob + 2 * t2] = rgb2;
  p.out[ob + 3 * t2] = fminf(cum, 1.0f);
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
  Params p;
  p.gid = gid;
  p.scal = scal;
  p.ray_o = ray_o;
  p.ray_d = ray_d;
  p.ray_mm = ray_mm;
  p.tmpl = tmpl;
  p.warp = warp;
  p.out = out;
  p.mh = mh;
  p.bs = bs;
  p.nbuf = nbuf;
  p.dt = dt;
  p.fadescale = fadescale;
  p.fadeexp = fadeexp;
  p.fade_int = (fadeexp == floorf(fadeexp) && fadeexp >= 1.0f && fadeexp <= 16.0f)
                   ? (int)fadeexp : 0;
  const size_t smem = mvp_march_fwd_smem_bytes(tsz, mh);
  cudaError_t err = cudaFuncSetAttribute(
      mvp_march_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (ntiles > 0) {
    mvp_march_fwd_kernel<<<ntiles, tsz, smem, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
