// Copyright (c) ava256_tpu contributors.
// All rights reserved.
//
// This source code is licensed under the license found in the
// LICENSE file in the root directory of this source tree.
//
// Device code shared by the forward and backward MVP raymarch kernels
// (mvp_march_fwd.cu, mvp_march_bwd.cu): the per-candidate slab test, the
// fade, the trilinear sample, the tile-coherent row ranges and the march of
// one window of step rows into shared memory. One block marches one tile of
// rays, one thread per ray. The arithmetic and its order are those of the
// plain PyTorch versions in ava256_tpu_torch/ops/raymarch_cuda.py; build
// with --fmad=false so that every product and sum rounds on its own as there.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mvp {

constexpr int kWindow = 16;  // step rows per shared-memory window

struct Scene {
  const int* gid;       // [NT, MH] flat primitive index (n * K + k)
  const float* scal;    // [NT, MH, 12] affine A (row-major 3x3) then b
  const float* ray_o;   // [NT, 3, T2]
  const float* ray_d;   // [NT, 3, T2]
  const float* ray_mm;  // [NT, 2, T2] tmin, tmax (tmax clamped to nbuf rows)
  const float* tmpl;    // [N*K, bs, bs, bs, 4] channels-last RGBA boxes
  const float* warp;    // [N*K, bs, bs, bs, 3] or nullptr
  int mh, bs, nbuf, fade_int;
  float dt, fadescale, fadeexp;
};

inline Scene make_scene(const int* gid, const float* scal, const float* ray_o,
                        const float* ray_d, const float* ray_mm, const float* tmpl,
                        const float* warp, int mh, int bs, int nbuf, float dt, float fadescale,
                        float fadeexp) {
  Scene p;
  p.gid = gid;
  p.scal = scal;
  p.ray_o = ray_o;
  p.ray_d = ray_d;
  p.ray_mm = ray_mm;
  p.tmpl = tmpl;
  p.warp = warp;
  p.mh = mh;
  p.bs = bs;
  p.nbuf = nbuf;
  p.dt = dt;
  p.fadescale = fadescale;
  p.fadeexp = fadeexp;
  p.fade_int = (fadeexp == floorf(fadeexp) && fadeexp >= 1.0f && fadeexp <= 16.0f)
                   ? (int)fadeexp : 0;
  return p;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const Scene& p, size_t tile, int t2, int tid) {
  Ray r;
  const size_t rb = tile * 3 * t2 + tid;
  r.ox = p.ray_o[rb], r.oy = p.ray_o[rb + t2], r.oz = p.ray_o[rb + 2 * t2];
  r.dx = p.ray_d[rb], r.dy = p.ray_d[rb + t2], r.dz = p.ray_d[rb + 2 * t2];
  const size_t mb = tile * 2 * t2 + tid;
  r.tmin = p.ray_mm[mb], r.tmax = p.ray_mm[mb + t2];
  return r;
}

struct Slab {
  float o[3], d[3], tin, tout;
  bool seg;
};

// Local ray of one candidate and its slab interval clipped to [tmin, tmax)
// (raymarch_pallas.py _prim_setup).
__device__ __forceinline__ Slab slab(const float* s, const Ray& ray) {
  Slab r;
  float lo[3], hi[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.o[j] = ray.ox * s[j] + ray.oy * s[3 + j] + ray.oz * s[6 + j] + s[9 + j];
    r.d[j] = ray.dx * s[j] + ray.dy * s[3 + j] + ray.dz * s[6 + j];
    float dc = r.d[j];
    if (fabsf(dc) < 1e-9f) dc = dc >= 0.0f ? 1e-9f : -1e-9f;
    const float t1 = (-1.0f - r.o[j]) / dc;
    const float t2 = (1.0f - r.o[j]) / dc;
    lo[j] = fminf(t1, t2);
    hi[j] = fmaxf(t1, t2);
  }
  r.tin = fmaxf(fmaxf(fmaxf(lo[0], lo[1]), lo[2]), ray.tmin);
  r.tout = fminf(fminf(fminf(hi[0], hi[1]), hi[2]), ray.tmax);
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

// One sample of a candidate at step row r: everything the forward blends and
// the backward chains through.
struct Sample {
  float t, y[3], fade, u;
  float f[3];   // cell coordinates of y
  float f2[3];  // cell coordinates the template is read at (warped, or f)
  float sm[4];  // template sample
};

// False when the sample is masked out (outside the box or the slab interval).
__device__ __forceinline__ bool eval_sample(const Scene& p, const Ray& ray, const Slab& s,
                                            const float* tb, const float* wb, float half, int r,
                                            Sample& o) {
  o.t = ray.tmin + (float)r * p.dt;
  o.y[0] = s.o[0] + o.t * s.d[0];
  o.y[1] = s.o[1] + o.t * s.d[1];
  o.y[2] = s.o[2] + o.t * s.d[2];
  const bool inbox = o.y[0] >= -1.0f && o.y[0] <= 1.0f && o.y[1] >= -1.0f && o.y[1] <= 1.0f &&
                     o.y[2] >= -1.0f && o.y[2] <= 1.0f;
  if (!(inbox && o.t >= s.tin && o.t < s.tout && o.t >= ray.tmin && o.t < ray.tmax)) return false;
  o.fade = expf(-p.fadescale *
                (pow_abs(o.y[0], p.fade_int, p.fadeexp) + pow_abs(o.y[1], p.fade_int, p.fadeexp) +
                 pow_abs(o.y[2], p.fade_int, p.fadeexp)));
  o.u = o.fade * p.dt;
#pragma unroll
  for (int j = 0; j < 3; ++j) o.f2[j] = o.f[j] = (o.y[j] + 1.0f) * half;
  if (wb) {
    float sw[3];
    trilinear<3>(wb, p.bs, o.f[0], o.f[1], o.f[2], sw);
#pragma unroll
    for (int j = 0; j < 3; ++j) o.f2[j] = (sw[j] + 1.0f) * half;
  }
  trilinear<4>(tb, p.bs, o.f2[0], o.f2[1], o.f2[2], o.sm);
  return true;
}

// The tile's candidate tables in shared memory: affines cs [mh][12], flat box
// index cgid [mh] and each candidate's tile-coherent step-row range
// [cr0, cr1) with the one-row margins of _prim_setup (clamp with 0 and nbuf
// before use). Ends with a barrier. rmin/rmax: the rows any candidate meets.
__device__ __forceinline__ void load_candidates(const Scene& p, size_t tile, const Ray& ray,
                                                float* cs, int* cr0, int* cr1, int* cgid,
                                                int& rmin, int& rmax) {
  const int t2 = blockDim.x, tid = threadIdx.x, mh = p.mh;
  for (int i = tid; i < mh * 12; i += t2) cs[i] = p.scal[tile * mh * 12 + i];
  for (int i = tid; i < mh; i += t2) {
    cgid[i] = p.gid[tile * mh + i];
    cr0[i] = p.nbuf;
    cr1[i] = 0;
  }
  __syncthreads();
  for (int c = 0; c < mh; ++c) {
    const Slab s = slab(cs + c * 12, ray);
    const float lo = s.seg ? floorf((s.tin - ray.tmin) / p.dt) - 1.0f : (float)p.nbuf;
    const float hi = s.seg ? ceilf((s.tout - ray.tmin) / p.dt) + 1.0f : 0.0f;
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
  rmin = p.nbuf, rmax = 0;
  for (int c = 0; c < mh; ++c) {
    const int r0 = max(cr0[c], 0), r1 = min(cr1[c], p.nbuf);
    if (r1 > r0) {
      rmin = min(rmin, r0);
      rmax = max(rmax, r1);
    }
  }
}

// Sum the samples of step rows [w0, w1) over the candidates, in candidate
// order, into acc [kWindow][4][t2]: rgb * a and a = alpha * fade * dt per
// row. Each thread owns its ray's column, so no barrier is needed. nsamp
// counts the samples this thread blended.
__device__ __forceinline__ void march_window(const Scene& p, const Ray& ray, const float* cs,
                                             const int* cr0, const int* cr1, const int* cgid,
                                             float* acc, int w0, int w1, unsigned& nsamp) {
  const int t2 = blockDim.x, tid = threadIdx.x;
  const size_t box = (size_t)p.bs * p.bs * p.bs;
  const float half = 0.5f * (float)(p.bs - 1);
  for (int i = 0; i < kWindow * 4; ++i) acc[i * t2 + tid] = 0.0f;
  for (int c = 0; c < p.mh; ++c) {
    const int lo = max(max(cr0[c], 0), w0);
    const int hi = min(min(cr1[c], p.nbuf), w1);
    if (lo >= hi) continue;  // uniform across the block
    const Slab s = slab(cs + c * 12, ray);
    if (!s.seg) continue;
    const size_t g = (size_t)cgid[c];
    const float* tb = p.tmpl + g * box * 4;
    const float* wb = p.warp ? p.warp + g * box * 3 : nullptr;
    for (int r = lo; r < hi; ++r) {
      Sample sp;
      if (!eval_sample(p, ray, s, tb, wb, half, r, sp)) continue;
      ++nsamp;
      const float a = sp.sm[3] * sp.u;
      float* row = acc + (r - w0) * 4 * t2 + tid;
      row[0] = row[0] + sp.sm[0] * a;
      row[t2] = row[t2] + sp.sm[1] * a;
      row[2 * t2] = row[2 * t2] + sp.sm[2] * a;
      row[3 * t2] = row[3 * t2] + a;
    }
  }
}

}  // namespace mvp
