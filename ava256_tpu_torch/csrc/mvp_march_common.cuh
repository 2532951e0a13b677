// Copyright (c) ava256_tpu contributors.
// All rights reserved.
//
// This source code is licensed under the license found in the
// LICENSE file in the root directory of this source tree.
//
// Device code shared by the forward and backward MVP raymarch kernels
// (mvp_march_fwd.cu, mvp_march_bwd.cu): the per-candidate slab test, the
// fade, the trilinear sample, the candidates' row ranges and the march of one
// window of step rows into shared memory. One block marches one tile of
// rays, one thread per ray. The arithmetic and its order are those of the
// plain PyTorch versions in ava256_tpu_torch/ops/raymarch_cuda.py; build
// with --fmad=false so that every product and sum rounds on its own as there.
//
// What bounds the march on an H100 is neither device-memory bytes nor the
// fp32 rate but the instructions and the dependent L1/L2 corner loads of a
// sample, times the share of a warp's lanes that hold a live sample (PERF.md
// has the readings: several hundred scheduler slots per warp trip, with
// about half of the lanes live when every ray walked the tile's union of
// rows). What the design does:
//
//   * The walk stays tile-coherent in candidates and windows: all rays of a
//     tile take candidate c of window w together, because neighbouring rays
//     meet the same candidates at nearly the same rows. (Per-ray candidate
//     masks with per-ray windows were built and measured: lanes of a warp
//     then sit in different candidates, fewer of them are live per trip, and
//     both kernels were slower. See PERF.md.)
//   * Inside a candidate each ray walks its own rows
//     [floor((tin - tmin) / dt) - 1, ceil((tout - tmin) / dt) + 1) (the
//     margins of _prim_setup; eval_sample keeps the exact test), not the
//     tile's union of them: a warp's trip count for a candidate is its
//     longest ray's, and a ray that misses the box does nothing.
//   * The trilinear sample has no branch: corner indices are clamped and a
//     corner outside the box reads as zero by a select on the loaded cell
//     (so a non-finite value in the clamped cell does not reach the sum),
//     and the 8 cell loads of a sample are independent and in flight
//     together instead of one after the other behind 8 range tests. Each
//     RGBA cell is one 16-byte load (ld.global.nc.v4.f32), and a window
//     row's sums are one float4.
//   * |y|^8, the default fade, is three squarings in line instead of a loop
//     over the exponent's bits (the same products in the same order).
//   * The window's height is a template parameter of the march; both kernels
//     take 16 rows (8 and 4 were slower once the sample was cheaper).
//
// Candidate order is the tile's and each thread owns its column of the
// window, so every row sum adds the same terms in the same order as the
// plain version; a corner outside the box adds an exact zero.
//
// No wgmma: the work is a gather and a trilinear blend with data-dependent
// addresses, not a matrix product. No TMA: a box is read at 8 scattered
// cells per sample straight from L1/L2, where the flagship's boxes stay.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mvp {

constexpr unsigned kFull = 0xffffffffu;
// Rows of the forward's per-ray state [NT, kStateRows, T2], STATE_ROWS in
// ops/raymarch_cuda.py: the saturation row's sums (rgb, a), the final alpha,
// then the ReadExtremes of the ray's samples (rgb, alpha, neg).
constexpr int kStateRows = 8;

struct Scene {
  const int* gid;       // [NT, MH] flat primitive index (n * K + k)
  const float* scal;    // [NT, MH, 12] affine A (row-major 3x3) then b
  const float* ray_o;   // [NT, 3, T2]
  const float* ray_d;   // [NT, 3, T2]
  const float* ray_mm;  // [NT, 2, T2] tmin, tmax (tmax clamped to nbuf rows)
  const float* tmpl;    // [N*K, bs, bs, bs, 4] channels-last RGBA boxes, 16-byte aligned
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

// The ray's own step rows [lo, hi) of a candidate whose slab interval is not
// empty, with one row of margin on either side, clamped to [0, nbuf].
__device__ __forceinline__ void row_range(const Scene& p, const Ray& ray, const Slab& s, int& lo,
                                          int& hi) {
  const float l = floorf((s.tin - ray.tmin) / p.dt) - 1.0f;
  const float h = ceilf((s.tout - ray.tmin) / p.dt) + 1.0f;
  lo = (int)fminf(fmaxf(l, 0.0f), (float)p.nbuf);
  hi = (int)fminf(fmaxf(h, 0.0f), (float)p.nbuf);
}

// |x|^p by repeated squaring for integer p in [1, 16] (as _pow_abs does),
// powf otherwise.
__device__ __forceinline__ float pow_abs(float x, int p_int, float p) {
  const float a = fabsf(x);
  if (p_int == 0) return powf(a, p);
  if (p_int == 8) {  // the default fade exponent: the loop's three squarings
    const float a2 = a * a, a4 = a2 * a2;
    return a4 * a4;
  }
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

// One cell of a channels-last box: a 16-byte load for the RGBA template,
// scalar loads for the 3-channel warp box.
template <int C>
__device__ __forceinline__ void load_cell(const float* __restrict__ v, float* q) {
  if constexpr (C == 4) {
    const float4 c = __ldg(reinterpret_cast<const float4*>(v));
    q[0] = c.x, q[1] = c.y, q[2] = c.z, q[3] = c.w;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = __ldg(v + c);
  }
}

// The two corner indices of one axis, clamped into the box, their weights
// 1 - frac and frac, and whether each corner lies inside the box.
struct Axis {
  int i[2];
  float w[2];
  bool ok[2];
};

__device__ __forceinline__ Axis axis_corners(float f, float lim) {
  Axis a;
  const float f0 = floorf(f), f1 = f0 + 1.0f;
  const float w1 = f - f0;
  a.ok[0] = !(f0 < 0.0f || f0 > lim);
  a.ok[1] = !(f1 < 0.0f || f1 > lim);
  a.w[0] = 1.0f - w1;
  a.w[1] = w1;
  a.i[0] = (int)fminf(fmaxf(f0, 0.0f), lim);
  a.i[1] = (int)fminf(fmaxf(f1, 0.0f), lim);
  return a;
}

// max and min that return NaN when either operand is NaN (fmaxf and fminf
// drop it): a NaN cell read must not vanish from the extremes.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Extremes of the template cells one ray's samples read (the corners inside
// the box): max |rgb|, max |alpha| and min(0, alpha). The backward's
// fixed-point bound is taken over them, so a cell no sample reads (inf, or
// a negative density) does not reach it.
struct ReadExtremes {
  float rgb = 0.0f, alpha = 0.0f, neg = 0.0f;
};

// Align-corners trilinear sample of a channels-last [bs, bs, bs, C] box at
// cell coordinates (fx, fy, fz); corners outside the box read zero (a
// select on the clamped cell's value, not a branch: the 8 cell loads are
// independent). With kRead, the corners read go into *rd (an outside
// corner's zero changes none of its extremes).
template <int C, bool kRead = false>
__device__ __forceinline__ void trilinear(const float* __restrict__ vol, int bs, float fx,
                                          float fy, float fz, float* s,
                                          ReadExtremes* rd = nullptr) {
  const float lim = (float)(bs - 1);
  const Axis ax = axis_corners(fx, lim), ay = axis_corners(fy, lim), az = axis_corners(fz, lim);
  float q[8][C];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    load_cell<C>(vol + ((az.i[k >> 2] * bs + ay.i[(k >> 1) & 1]) * bs + ax.i[k & 1]) * C, q[k]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool ok = ax.ok[k & 1] && ay.ok[(k >> 1) & 1] && az.ok[k >> 2];
    const float w = (ax.w[k & 1] * ay.w[(k >> 1) & 1]) * az.w[k >> 2];
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = ok ? q[k][c] : 0.0f;
      s[c] = s[c] + v[c] * w;
    }
    if constexpr (kRead) {
      static_assert(C == 4, "the extremes are the RGBA template's");
      rd->rgb = max_nan(max_nan(max_nan(rd->rgb, fabsf(v[0])), fabsf(v[1])), fabsf(v[2]));
      rd->alpha = max_nan(rd->alpha, fabsf(v[3]));
      rd->neg = min_nan(rd->neg, v[3]);
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
// With kRead, the template corners the sample reads go into *rd.
template <bool kRead = false>
__device__ __forceinline__ bool eval_sample(const Scene& p, const Ray& ray, const Slab& s,
                                            const float* tb, const float* wb, float half, int r,
                                            Sample& o, ReadExtremes* rd = nullptr) {
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
  trilinear<4, kRead>(tb, p.bs, o.f2[0], o.f2[1], o.f2[2], o.sm, rd);
  return true;
}

// Lane-use counters of the probe instances (off on the main path): a trip is
// one execution of eval_sample by a warp with any lane active.
struct Probe {
  unsigned trips = 0, lanes = 0, useful = 0;
};

template <bool kProbe>
__device__ __forceinline__ void probe_trip(Probe& pr) {
  if constexpr (kProbe) {
    const unsigned am = __activemask();
    if ((threadIdx.x & 31) == __ffs(am) - 1) {
      ++pr.trips;
      pr.lanes += __popc(am);
    }
  }
}

// Adds the block's counters into out[0..3) (trips, lanes, useful). Call where
// the block's threads have converged.
__device__ __forceinline__ void probe_drain(const Probe& pr, unsigned long long* out) {
  const unsigned a = __reduce_add_sync(kFull, pr.trips), b = __reduce_add_sync(kFull, pr.lanes),
                 c = __reduce_add_sync(kFull, pr.useful);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(out, (unsigned long long)a);
    atomicAdd(out + 1, (unsigned long long)b);
    atomicAdd(out + 2, (unsigned long long)c);
  }
}

// A tile's tables in dynamic shared memory, for windows of W rows.
struct Tables {
  float4* acc;  // [W][t2] the window's row sums (rgb * a, a); a thread owns its column
  float* cs;    // [mh][12] candidate affines
  int* cgid;    // [mh] flat box index
  int* cr0;     // [mh] each candidate's tile-coherent step-row range [cr0, cr1):
  int* cr1;     //      the union of the rays' own ranges
};

__host__ __device__ inline size_t tables_bytes(int window, int t2, int mh) {
  return sizeof(float4) * window * t2 + sizeof(float) * 12 * mh + sizeof(int) * 3 * mh;
}

__device__ __forceinline__ Tables carve_tables(float4* smem, int window, int t2, int mh) {
  Tables tb;
  tb.acc = smem;
  tb.cs = reinterpret_cast<float*>(smem + window * t2);
  tb.cgid = reinterpret_cast<int*>(tb.cs + 12 * mh);
  tb.cr0 = tb.cgid + mh;
  tb.cr1 = tb.cr0 + mh;
  return tb;
}

// Loads the tile's candidate table and each candidate's tile-coherent row
// range. Ends with a barrier. [rmin, rmax): the rows any candidate meets.
__device__ __forceinline__ void load_candidates(const Scene& p, size_t tile, const Ray& ray,
                                                const Tables& tb, int& rmin, int& rmax) {
  const int t2 = blockDim.x, tid = threadIdx.x, mh = p.mh;
  for (int i = tid; i < mh * 12; i += t2) tb.cs[i] = p.scal[tile * mh * 12 + i];
  for (int i = tid; i < mh; i += t2) {
    tb.cgid[i] = p.gid[tile * mh + i];
    tb.cr0[i] = p.nbuf;
    tb.cr1[i] = 0;
  }
  __syncthreads();
  for (int c = 0; c < mh; ++c) {
    const Slab s = slab(tb.cs + c * 12, ray);
    int lo = p.nbuf, hi = 0;
    if (s.seg) row_range(p, ray, s, lo, hi);
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if ((tid & 31) == 0 && lo < hi) {
      atomicMin(tb.cr0 + c, lo);
      atomicMax(tb.cr1 + c, hi);
    }
  }
  __syncthreads();
  rmin = p.nbuf, rmax = 0;
  for (int c = 0; c < mh; ++c) {
    if (tb.cr1[c] > tb.cr0[c]) {
      rmin = min(rmin, tb.cr0[c]);
      rmax = max(rmax, tb.cr1[c]);
    }
  }
}

// Calls f(c, slab, lo, hi) for each candidate whose tile-coherent range meets
// the window [w0, w1), in candidate order, on every thread of the block;
// [lo, hi) are this ray's own rows of the candidate inside the window, empty
// when the ray misses it.
template <typename F>
__device__ __forceinline__ void for_each_candidate(const Scene& p, const Ray& ray,
                                                   const Tables& tb, int w0, int w1, F f) {
  for (int c = 0; c < p.mh; ++c) {
    if (max(tb.cr0[c], w0) >= min(tb.cr1[c], w1)) continue;  // uniform across the block
    const Slab s = slab(tb.cs + c * 12, ray);
    int lo = 0, hi = 0;
    if (s.seg) row_range(p, ray, s, lo, hi);
    f(c, s, max(lo, w0), min(hi, w1));
  }
}

// Sums the samples of step rows [w0, w1) over the candidates, in candidate
// order, into acc: rgb * a and a = alpha * fade * dt per row. Each thread
// owns its ray's column, so no barrier is needed. nsamp counts the samples
// this thread blended; with kRead, the template corners they read go into
// *rd.
template <int W, bool kProbe, bool kRead = false>
__device__ __forceinline__ void march_window(const Scene& p, const Ray& ray, const Tables& tb,
                                             int w0, int w1, unsigned& nsamp, Probe& pr,
                                             ReadExtremes* rd = nullptr) {
  const int t2 = blockDim.x, tid = threadIdx.x;
  const size_t box = (size_t)p.bs * p.bs * p.bs;
  const float half = 0.5f * (float)(p.bs - 1);
#pragma unroll
  for (int i = 0; i < W; ++i) tb.acc[i * t2 + tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for_each_candidate(p, ray, tb, w0, w1, [&](int c, const Slab& s, int lo, int hi) {
    const size_t g = (size_t)tb.cgid[c];
    const float* tbox = p.tmpl + g * box * 4;
    const float* wbox = p.warp ? p.warp + g * box * 3 : nullptr;
    for (int r = lo; r < hi; ++r) {
      Sample sp;
      probe_trip<kProbe>(pr);
      if (!eval_sample<kRead>(p, ray, s, tbox, wbox, half, r, sp, rd)) continue;
      ++nsamp;
      if constexpr (kProbe) ++pr.useful;
      const float a = sp.sm[3] * sp.u;
      float4 row = tb.acc[(r - w0) * t2 + tid];
      row.x = row.x + sp.sm[0] * a;
      row.y = row.y + sp.sm[1] * a;
      row.z = row.z + sp.sm[2] * a;
      row.w = row.w + a;
      tb.acc[(r - w0) * t2 + tid] = row;
    }
  });
}

// True on every thread once every ray of the tile has saturated or can take
// no further sample after row w1. A barrier.
__device__ __forceinline__ bool tile_done(const Scene& p, const Ray& ray, float cum, int w1) {
  const bool done = cum >= 1.0f || !(ray.tmin < ray.tmax) ||
                    ray.tmin + (float)w1 * p.dt >= ray.tmax;
  return __syncthreads_and(done);
}

}  // namespace mvp
