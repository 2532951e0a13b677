// Copyright (c) ava256_tpu contributors.
// All rights reserved.
//
// This source code is licensed under the license found in the
// LICENSE file in the root directory of this source tree.
//
// 2D bilinear grid sampling with zeros padding for Hopper (sm_90a), plain C
// interface: the forward and a backward whose image gradient has the same
// bits on every run and every route.
//
// Replaces F.grid_sample (mode="bilinear", padding_mode="zeros") on the
// card, whose backward adds into the image gradient with float atomics and
// has no deterministic form in PyTorch. It has no Pallas counterpart: the
// JAX package samples with XLA gathers (ava256_tpu/ops/grid_sample.py,
// packed or four-gather form). The port calls it from the identity
// encoder's warp of every bias-pyramid level (models/encoders/identity.py:
// an [N, H, W, C] view of a conv output, channels-last where the convs run
// channels-last, sampled on one warp grid expanded over the batch, the
// output of the image's size) and the
// geometry decoder's vertex sampling (models/decoders/geometry.py: grid
// [N, V, 1, 2]).
//
// Layout: img, out, gout and gimg are [N, H, W, C]-shaped views with any
// element strides (channels-last or channels-first planes); the grid is
// [N, Ho, Wo, 2] with any strides, batch stride 0 for a grid shared by the
// batch. ops/grid_sample.py allocates out and gimg in the image's memory
// format, checks that every offset fits in 32 bits, and plans every launch
// (tiles, lanes, batch and channel groups; the same numbers its CPU tests
// check). Source coordinates and weights are PyTorch's, each operation
// rounded on its own (__fadd_rn, __fmul_rn, ...): ((x + 1) W - 1) / 2, or
// ((x + 1) / 2) (W - 1) with align_corners; nw = ((fx + 1) - ix) ((fy + 1) -
// iy), ne = (ix - fx) ((fy + 1) - iy), sw = ((fx + 1) - ix) (iy - fy), se =
// (ix - fx) (iy - fy). A corner outside the image reads zero.
//
// The image gradient is defined exactly: the int64 sum, over every output
// pixel and corner that reads the cell, of rint_even(w * gout * 2^k), turned
// into float32 as float(q) * 2^-k. 2^k comes from the sound bound sum |gout|
// (a pixel's four weights sum to 1, so no sum leaves int64). Integer sums are
// associative, so both routes below, any tiling and any order give the same
// bits, and ops/grid_sample.grid_sample_bwd_fixed_plain restates it in
// PyTorch.
//
//   fwd_pixels   one thread per output pixel: the grid is read once, the
//                corners and weights computed once and reused over the
//                block's channels and, for a shared grid, over the batch;
//                x-adjacent threads read x-adjacent cells of each plane, so
//                a near-identity warp's four corner reads coalesce. Channel
//                and batch groups over blockIdx.y / z fill the card on small
//                levels. C = 3 leaves no lane idle.
//   fwd_packed4  channels-last images with C % 4 == 0: one thread per pixel
//                and 16-byte channel vector.
//   bwd_prep     one launch: sum |gout| in float64 in a fixed order
//                (per-block partials in fixed slots, folded in index order
//                by the last block), the scale and 1 / scale by
//                fixed_point.scale_for's rule, and the count of output
//                pixels whose sample reads a cell outside that cell's
//                window (the owner route's premise, below).
//   bwd_owner    the owner route, for an output of the image's size of at
//                least 32^2 (the warp levels but the two smallest, where
//                the scatter route is faster): a block owns a tile of gimg
//                cells (and a group
//                of channels, and of batch items). It computes the corners
//                and weights of the output pixels of the tile's window (the
//                tile moved by minus the displacement of its centre sample,
//                widened by D cells) into shared memory once, and lists for
//                each cell the (pixel, corner) pairs that read it, in a
//                compact run per cell (32-bit shared atomics for the counts
//                and places; each run then sorted). Each thread then owns a
//                cell: for each batch item and channel it sums the rounded
//                addends of its run in an int64 register (four channels a
//                16-byte gout load where gout and gimg are channels-last)
//                and writes float(q) 2^-k once: no global table, no zero
//                fill, no
//                conversion pass, no atomic on the sums. When the block
//                holds every channel it also computes the grid gradient of
//                its cells' own pixels (the output has the image's size),
//                each channel in order. When the prep's count is not 0 it
//                writes no gimg: the scatter route does.
//   bwd_scatter  the scatter route (the vertex sampling, the small warp
//                levels, and a warp level whose count is not 0): each
//                addend into an int64 table with
//                a 64-bit integer atomic (fixed_point.cuh); with a grid
//                gradient (the vertex sampling's, and a warp level's whose
//                blocks split its channels), lanes over a pixel's channels
//                folded by a fixed tree. The table comes from torch.empty;
//                zero_table and to_float (fixed_point.cuh) clear and convert
//                it. On a warp level all three are predicated on the prep's
//                count: their blocks return at once when the owner route did
//                the work, and the owner blocks return at once (or after the
//                fused grid gradient) when it did not.
//
// A backward call on the owner route launches prep, owner, zero, scatter
// and to_float: 5 kernels; on the scatter route prep, zero, scatter,
// to_float.
//
// What bounds it: device-memory bytes. The forward reads each image cell
// about once (the corner reads of neighbouring threads overlap in L1) and
// writes the output once. The owner backward reads the gout of the pixels
// whose corners fall in the tile (each element by the ~4 cells it reads, one
// channel plane or four channels at a time, so the repeats hit L1) and
// writes gimg once; with
// the grid gradient it reads the image once more; the prep reads gout once
// more (the scale must be known before the first addend). No matrix product;
// the int64 sums stay in registers. Measured on the card (PERF.md), the
// owner kernel takes several times these bytes' time: each (pixel, corner)
// pair of a channel waits on a chain of two shared-memory reads and a gout
// load; staging gout in shared memory, holding a cell's pairs in registers,
// 64-bit shared atomics and other tile plans did not shorten it.

#include "fixed_point.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kFar = -2;   // the corner index of a sample that reads nothing

// The arguments of a call, in the order of ops/grid_sample.py ARG_NAMES.
struct Args {
  long long nfields;
  long long n, h, w, c, ho, wo, align, shared;
  long long img[4], grid[4], gout[4], out[4];  // element strides (n, y, x, c)
  long long fwd_packed, fwd_cpg, fwd_cgroups, fwd_bpg, fwd_bgroups, fwd_blocks;
  long long route, radius, tw, th, tiles_x, tiles_y, cpg, cgroups, bpg, bgroups, smem;
  long long nsum, sum_chunk, ncnt;
  long long gsz[4], gst[4];  // gout's dims for the scale's sum, outermost first
  long long sc_lanes, sc_blocks, sc_iters, numel, tbl_blocks, fuse_grid, owner_vec4;
};
constexpr long long kFields = sizeof(Args) / sizeof(long long);

struct S4 {
  int n, y, x, c;
};

struct Geom {
  int n, h, w, c, ho, wo, align, shared;
  S4 img, grid, gout, out;
};

S4 s4(const long long* s) { return S4{(int)s[0], (int)s[1], (int)s[2], (int)s[3]}; }

Geom geom(const Args& a) {
  return Geom{(int)a.n,  (int)a.h,      (int)a.w,      (int)a.c,      (int)a.ho,
              (int)a.wo, (int)a.align,  (int)a.shared, s4(a.img),     s4(a.grid),
              s4(a.gout), s4(a.out)};
}

struct Corners {
  int x0, y0;       // the nw corner; kFar when the sample reads nothing
  float ix, iy;     // the source coordinates
  float w[4];       // nw, ne, sw, se
  bool v[4];        // the corner lies in the image
};

__device__ __forceinline__ float unnormalize(float x, int size, int align) {
  const float x1 = __fadd_rn(x, 1.0f);
  return align ? __fmul_rn(__fmul_rn(x1, 0.5f), (float)(size - 1))
               : __fmul_rn(__fsub_rn(__fmul_rn(x1, (float)size), 1.0f), 0.5f);
}

__device__ __forceinline__ Corners corners_at(const float* grid, int b, int y, int x,
                                              const Geom& g) {
  const float* p = grid + b * g.grid.n + y * g.grid.y + x * g.grid.x;
  Corners k;
  k.ix = unnormalize(__ldg(p), g.w, g.align);
  k.iy = unnormalize(__ldg(p + g.grid.c), g.h, g.align);
  const float fx = floorf(k.ix), fy = floorf(k.iy);
  const float ax = __fsub_rn(__fadd_rn(fx, 1.0f), k.ix), ay = __fsub_rn(__fadd_rn(fy, 1.0f), k.iy);
  const float ex = __fsub_rn(k.ix, fx), ey = __fsub_rn(k.iy, fy);
  k.w[0] = __fmul_rn(ax, ay);
  k.w[1] = __fmul_rn(ex, ay);
  k.w[2] = __fmul_rn(ax, ey);
  k.w[3] = __fmul_rn(ex, ey);
  // float -> int only where the value is in range; far samples read nothing
  const bool near = fx > -2.0f && fx < (float)g.w + 1.0f && fy > -2.0f && fy < (float)g.h + 1.0f;
  k.x0 = near ? (int)fx : kFar;
  k.y0 = near ? (int)fy : kFar;
  const bool x0in = near && k.x0 >= 0 && k.x0 < g.w, x1in = near && k.x0 + 1 >= 0 && k.x0 + 1 < g.w;
  const bool y0in = near && k.y0 >= 0 && k.y0 < g.h, y1in = near && k.y0 + 1 >= 0 && k.y0 + 1 < g.h;
  k.v[0] = x0in && y0in;
  k.v[1] = x1in && y0in;
  k.v[2] = x0in && y1in;
  k.v[3] = x1in && y1in;
  return k;
}

// The owner route's tiles of tw x th cells, and the window of output pixels
// each reads from. A warp level's grid is not an identity: the model's
// identity grid (linspace(-1, 1), resized with half-pixel centres, sampled
// with align_corners False) stretches the image by up to 4 cells at 1024^2
// and squeezes the 4 border pixels onto one position, and the learned warp
// moves it further. So a tile's window is the tile moved by minus the
// displacement of the sample of its centre pixel, (sx, sy) = nw corner -
// pixel there (0 for a sample that reads nothing), and widened by D cells on
// each side.
struct Tiles {
  int tw, th;
};

__device__ __forceinline__ void tile_shift(const float* grid, int b, int tx, int ty,
                                           const Tiles& t, const Geom& g, int& sx, int& sy) {
  const int px = min(tx * t.tw + t.tw / 2, g.w - 1), py = min(ty * t.th + t.th / 2, g.h - 1);
  const Corners k = corners_at(grid, b, py, px, g);
  const bool far = k.x0 == kFar;
  sx = far ? 0 : k.x0 - px;
  sy = far ? 0 : k.y0 - py;
}

// A corner of the sample of pixel (px, py) reads the image at a cell whose
// tile's window does not hold the pixel: the owner route would miss its
// addend.
__device__ __forceinline__ bool escapes(const float* grid, int b, const Corners& k, int px,
                                        int py, int r, const Tiles& t, const Geom& g) {
  bool e = false;
  int ltx = -1, lty = -1, sx = 0, sy = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!k.v[i]) continue;
    const int cx = k.x0 + (i & 1), cy = k.y0 + (i >> 1);
    const int tx = cx / t.tw, ty = cy / t.th;
    if (tx != ltx || ty != lty) {
      tile_shift(grid, b, tx, ty, t, g, sx, sy);
      ltx = tx;
      lty = ty;
    }
    const int wx = px + sx - tx * t.tw, wy = py + sy - ty * t.th;
    e = e || wx < -r || wx >= t.tw + r || wy < -r || wy >= t.th + r;
  }
  return e;
}

// PyTorch's grid-gradient terms of one channel, in its order.
__device__ __forceinline__ void grid_terms(const Corners& k, const float* ic, int rnw,
                                           const S4& s, float go, float& gix, float& giy) {
  const float x_nw = (float)k.x0, y_nw = (float)k.y0;  // = x_sw, y_ne
  const float x_se = (float)(k.x0 + 1), y_se = (float)(k.y0 + 1);  // = x_ne, y_sw
  if (k.v[0]) {
    const float v = __ldg(ic + rnw);
    gix = __fsub_rn(gix, __fmul_rn(__fmul_rn(v, __fsub_rn(y_se, k.iy)), go));
    giy = __fsub_rn(giy, __fmul_rn(__fmul_rn(v, __fsub_rn(x_se, k.ix)), go));
  }
  if (k.v[1]) {
    const float v = __ldg(ic + rnw + s.x);
    gix = __fadd_rn(gix, __fmul_rn(__fmul_rn(v, __fsub_rn(y_se, k.iy)), go));
    giy = __fsub_rn(giy, __fmul_rn(__fmul_rn(v, __fsub_rn(k.ix, x_nw)), go));
  }
  if (k.v[2]) {
    const float v = __ldg(ic + rnw + s.y);
    gix = __fsub_rn(gix, __fmul_rn(__fmul_rn(v, __fsub_rn(k.iy, y_nw)), go));
    giy = __fadd_rn(giy, __fmul_rn(__fmul_rn(v, __fsub_rn(x_se, k.ix)), go));
  }
  if (k.v[3]) {
    const float v = __ldg(ic + rnw + s.x + s.y);
    gix = __fadd_rn(gix, __fmul_rn(__fmul_rn(v, __fsub_rn(k.iy, y_nw)), go));
    giy = __fadd_rn(giy, __fmul_rn(__fmul_rn(v, __fsub_rn(k.ix, x_nw)), go));
  }
}

__device__ __forceinline__ float grid_mult(int size, int align) {
  return align ? __fmul_rn((float)(size - 1), 0.5f) : __fmul_rn((float)size, 0.5f);
}

__device__ __forceinline__ int nw_offset(const Corners& k, const S4& s) {
  return k.y0 * s.y + k.x0 * s.x;  // a corner may sit at -1 (or kFar: never read)
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// registers for six blocks an SM: the loads of more threads in flight (measured)
__global__ void __launch_bounds__(kBlock, 6) fwd_pixels(const float* __restrict__ img,
                                                     const float* __restrict__ grid,
                                                     float* __restrict__ out, Geom g, int cpg,
                                                     int bpg) {
  const int pix = blockIdx.x * kBlock + threadIdx.x;
  if (pix >= g.ho * g.wo) return;
  const int oy = pix / g.wo, ox = pix - oy * g.wo;
  const int c0 = blockIdx.y * cpg, c1 = min(g.c, c0 + cpg);
  const int b0 = blockIdx.z * bpg, b1 = min(g.n, b0 + bpg);
  Corners k = corners_at(grid, g.shared ? 0 : b0, oy, ox, g);
  for (int b = b0; b < b1; ++b) {
    if (b != b0 && !g.shared) k = corners_at(grid, b, oy, ox, g);
    const int rnw = nw_offset(k, g.img);
    const float* ib = img + b * g.img.n;
    float* ob = out + b * g.out.n + oy * g.out.y + ox * g.out.x;
#pragma unroll 4
    for (int c = c0; c < c1; ++c) {
      const float* ic = ib + c * g.img.c;
      float acc = 0.0f;
      if (k.v[0]) acc = __fadd_rn(acc, __fmul_rn(__ldg(ic + rnw), k.w[0]));
      if (k.v[1]) acc = __fadd_rn(acc, __fmul_rn(__ldg(ic + rnw + g.img.x), k.w[1]));
      if (k.v[2]) acc = __fadd_rn(acc, __fmul_rn(__ldg(ic + rnw + g.img.y), k.w[2]));
      if (k.v[3]) acc = __fadd_rn(acc, __fmul_rn(__ldg(ic + rnw + g.img.x + g.img.y), k.w[3]));
      ob[c * g.out.c] = acc;
    }
  }
}

__device__ __forceinline__ void madd4(float4& acc, const float4 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
}

__global__ void __launch_bounds__(kBlock) fwd_packed4(const float* __restrict__ img,
                                                      const float* __restrict__ grid,
                                                      float* __restrict__ out, Geom g) {
  const int quads = g.c / 4;
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= g.n * g.ho * g.wo * quads) return;
  const int quad = t % quads, pix = t / quads;
  const int b = pix / (g.ho * g.wo), rem = pix - b * g.ho * g.wo;
  const int oy = rem / g.wo, ox = rem - oy * g.wo;
  const Corners k = corners_at(grid, g.shared ? 0 : b, oy, ox, g);
  const float* ib = img + b * g.img.n + 4 * quad;
  const int rnw = nw_offset(k, g.img);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k.v[0]) madd4(acc, __ldg(reinterpret_cast<const float4*>(ib + rnw)), k.w[0]);
  if (k.v[1]) madd4(acc, __ldg(reinterpret_cast<const float4*>(ib + rnw + g.img.x)), k.w[1]);
  if (k.v[2]) madd4(acc, __ldg(reinterpret_cast<const float4*>(ib + rnw + g.img.y)), k.w[2]);
  if (k.v[3]) {
    madd4(acc, __ldg(reinterpret_cast<const float4*>(ib + rnw + g.img.x + g.img.y)), k.w[3]);
  }
  *reinterpret_cast<float4*>(out + b * g.out.n + oy * g.out.y + ox * g.out.x + 4 * quad) = acc;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The per-call work buffer: Meta, then nsum float64 partials, then ncnt
// int32 escape counts.
struct Meta {
  float scale, inv;
  int count, pad;
};

struct Flat4 {
  int sz[4], st[4];  // outermost first
};

__device__ __forceinline__ int flat_offset(int i, const Flat4& f) {
  if (f.sz[0] == 1 && f.sz[1] == 1 && f.sz[2] == 1) return i * f.st[3];
  int off = 0;
#pragma unroll
  for (int d = 3; d >= 0; --d) {
    const int q = i / f.sz[d];
    off += (i - q * f.sz[d]) * f.st[d];
    i = q;
  }
  return off;
}

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {  // a fixed tree; every thread gets the sum
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const T r = sh[0];
  __syncthreads();
  return r;
}

// registers for eight blocks an SM (measured)
__global__ void __launch_bounds__(kBlock, 8) bwd_prep(const float* __restrict__ gout, Flat4 f,
                                                   int numel, int nsum, int chunk,
                                                   const float* __restrict__ grid, Geom g,
                                                   int radius, Tiles tiles, int ncnt,
                                                   unsigned char* work, int* sync) {
  __shared__ double sd[kBlock];
  __shared__ int si[kBlock];
  __shared__ bool last;
  Meta* meta = reinterpret_cast<Meta*>(work);
  double* part = reinterpret_cast<double*>(work + sizeof(Meta));
  int* cnt = reinterpret_cast<int*>(part + nsum);
  const int bid = blockIdx.x;
  if (bid < nsum) {
    // four loads in flight a thread: four partial sums, folded in order
    double s4[4] = {0.0, 0.0, 0.0, 0.0};
    const int i1 = min(numel, (bid + 1) * chunk);
    int i = bid * chunk + threadIdx.x;
    for (; i + 3 * kBlock < i1; i += 4 * kBlock) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s4[u] += fabs((double)__ldg(gout + flat_offset(i + u * kBlock, f)));
    }
    for (; i < i1; i += kBlock) s4[0] += fabs((double)__ldg(gout + flat_offset(i, f)));
    double s = block_sum(((s4[0] + s4[1]) + s4[2]) + s4[3], sd);
    if (threadIdx.x == 0) part[bid] = s;
  } else {
    int e = 0;
    const int npix = (g.shared ? 1 : g.n) * g.ho * g.wo;
    for (int p = (bid - nsum) * kBlock + threadIdx.x; p < npix; p += ncnt * kBlock) {
      const int b = p / (g.ho * g.wo), rem = p - b * g.ho * g.wo;
      const int y = rem / g.wo, x = rem - y * g.wo;
      e += escapes(grid, b, corners_at(grid, b, y, x, g), x, y, radius, tiles, g);
    }
    e = block_sum(e, si);
    if (threadIdx.x == 0) cnt[bid - nsum] = e;
  }
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(sync, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  double s = 0.0;  // thread t folds slots t, t + 256, ... in order, then a fixed tree
  for (int i = threadIdx.x; i < nsum; i += kBlock) s += __ldcg(part + i);
  s = block_sum(s, sd);
  int e = 0;
  for (int i = threadIdx.x; i < ncnt; i += kBlock) e += __ldcg(cnt + i);
  e = block_sum(e, si);
  if (threadIdx.x == 0) {
    const float scale = fxp::scale_for(s);
    meta->scale = scale;
    meta->inv = 1.0f / scale;
    meta->count = g.shared ? e * g.n : e;  // output pixels, the batch counted
    if (meta->count != 0) atomicAdd(sync + 1, 1);  // calls the owner route could not take
    sync[0] = 0;
  }
}

struct OwnerPlan {
  int tw, th, tiles_x, radius, cpg, bpg, fuse_grid, vec4;
};

// rint_even(w * go * scale), or 0 and bad set when it is not below 2^62.
__device__ __forceinline__ long long rounded(float w, float go, float scale, bool& bad) {
  const float x = __fmul_rn(__fmul_rn(w, go), scale);
  const bool ok = fabsf(x) < fxp::kLimit;
  bad = bad || !ok;
  return ok ? __float2ll_rn(x) : 0ll;
}

// The owner route's image gradient (see the header), for the block's tile
// (tx, ty), its channel group and batch items [b0, b1). Shared memory: for
// each pixel of the window its four weights [4][hn], its gout offset and its
// corners in the tile (the nw corner's cell index in the tile times 16, plus
// a bit for each corner that lies in the tile and the image); for each cell
// the (pixel, corner) pairs that read it, as a compact list (window index |
// corner << 12) in runs of cells (run start and length), each run sorted by
// window index: the int64 sums are the same in any order, the sorted runs
// keep neighbouring cells' reads of gout next to each other.
__device__ __forceinline__ void owner_image_grad(const float* __restrict__ grid,
                                                 const float* __restrict__ gout,
                                                 float* __restrict__ gimg,
                                                 const unsigned char* work, unsigned* flag,
                                                 const Geom& g, const OwnerPlan& p,
                                                 unsigned char* smem, int tx, int ty, int b0,
                                                 int b1, bool live) {
  const int r = p.radius, cells = p.tw * p.th;
  const int hw = p.tw + 2 * r, hn = hw * (p.th + 2 * r);
  float* sw = reinterpret_cast<float*>(smem);  // [4][hn]
  int* spix = reinterpret_cast<int*>(sw + 4 * hn);
  int* scell = spix + hn;
  int* cnt = scell + hn;     // [cells]
  int* start = cnt + cells;  // [cells + 1]
  unsigned short* pairs = reinterpret_cast<unsigned short*>(start + cells + 1);  // [4 hn]
  const int ox = tx * p.tw, oy = ty * p.th;
  const int c0g = blockIdx.y * p.cpg, c1g = min(g.c, c0g + p.cpg);
  const int gb = g.shared ? 0 : b0;  // bpg is 1 for a grid per batch item
  const int corner_off[4] = {0, 1, p.tw, p.tw + 1};
  for (int e = threadIdx.x; e < cells; e += blockDim.x) cnt[e] = 0;
  int sx, sy;
  tile_shift(grid, gb, tx, ty, Tiles{p.tw, p.th}, g, sx, sy);
  __syncthreads();
  for (int i = threadIdx.x; i < hn; i += blockDim.x) {
    const int hx = ox - sx - r + i % hw, hy = oy - sy - r + i / hw;
    int cell = 0;
    if (hx >= 0 && hx < g.wo && hy >= 0 && hy < g.ho) {
      const Corners k = corners_at(grid, gb, hy, hx, g);
      const int base = (k.y0 - oy) * p.tw + (k.x0 - ox);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cx = k.x0 + (q & 1) - ox, cy = k.y0 + (q >> 1) - oy;
        sw[q * hn + i] = k.w[q];
        if (k.v[q] && cx >= 0 && cx < p.tw && cy >= 0 && cy < p.th) {
          cell |= 1 << q;
          atomicAdd(cnt + base + corner_off[q], 1);
        }
      }
      if (cell) cell += base * 16;
      spix[i] = hy * g.gout.y + hx * g.gout.x;
    }
    scell[i] = cell;
  }
  __syncthreads();
  {  // the runs' starts: an exclusive prefix sum of the counts (cells <= blockDim)
    __shared__ int warp_sum[kBlock / 32];
    const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
    const int v = t < cells ? cnt[t] : 0;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sum[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      const int w = lane < kBlock / 32 ? warp_sum[lane] : 0;
      int wi = w;
      for (int o = 1; o < kBlock / 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, wi, o);
        if (lane >= o) wi += up;
      }
      if (lane < kBlock / 32) warp_sum[lane] = wi - w;
    }
    __syncthreads();
    if (t < cells) start[t] = cnt[t] = incl - v + warp_sum[wid];  // and the fill cursors
    if (t == cells - 1) start[cells] = incl + warp_sum[wid];
    __syncthreads();
  }
  for (int i = threadIdx.x; i < hn; i += blockDim.x) {
    const int s = scell[i], m = s & 15;
    if (m == 0) continue;
    const int base = (s - m) / 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((m >> q) & 1) pairs[atomicAdd(cnt + base + corner_off[q], 1)] = (unsigned short)(i | (q << 12));
    }
  }
  __syncthreads();
  if (!live) return;
  const int e = threadIdx.x;  // this thread's cell
  const int cx = ox + e % p.tw, cy = oy + e / p.tw;
  const int h0 = start[e], h1 = start[e + 1];
  for (int h = h0 + 1; h < h1; ++h) {  // sort the run by window index (insertion sort)
    const unsigned short v = pairs[h];
    int j = h - 1;
    for (; j >= h0 && (pairs[j] & 0xfff) > (v & 0xfff); --j) pairs[j + 1] = pairs[j];
    pairs[j + 1] = v;
  }
  const Meta* meta = reinterpret_cast<const Meta*>(work);
  const float scale = meta->scale, inv = meta->inv;
  const bool adds = scale == scale;  // a NaN scale adds nothing: gimg reads NaN
  bool bad = false;
  for (int b = b0; b < b1; ++b) {
    const float* gob = gout + b * g.gout.n;
    float* ob = gimg + b * g.out.n + cy * g.out.y + cx * g.out.x;
    if (p.vec4) {  // channels-last gout and gimg: four channels a 16-byte load
      for (int c = c0g; c < c1g; c += 4) {
        long long a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        for (int h = h0; adds && h < h1; ++h) {
          const int v = pairs[h], i = v & 0xfff;
          const float w = sw[(v >> 12) * hn + i];
          const float4 go = __ldg(reinterpret_cast<const float4*>(gob + spix[i] + c));
          a0 += rounded(w, go.x, scale, bad);
          a1 += rounded(w, go.y, scale, bad);
          a2 += rounded(w, go.z, scale, bad);
          a3 += rounded(w, go.w, scale, bad);
        }
        *reinterpret_cast<float4*>(ob + c) =
            make_float4(__fmul_rn(__ll2float_rn(a0), inv), __fmul_rn(__ll2float_rn(a1), inv),
                        __fmul_rn(__ll2float_rn(a2), inv), __fmul_rn(__ll2float_rn(a3), inv));
      }
      continue;
    }
    for (int c = c0g; c < c1g; ++c) {  // a channel at a time: its plane stays in L1
      long long acc = 0;
      const float* gc = gob + c * g.gout.c;
      for (int h = h0; adds && h < h1; ++h) {
        const int v = pairs[h], i = v & 0xfff;
        acc += rounded(sw[(v >> 12) * hn + i], __ldg(gc + spix[i]), scale, bad);
      }
      ob[c * g.out.c] = __fmul_rn(__ll2float_rn(acc), inv);
    }
  }
  if (bad) atomicOr(flag, 1u);
}

// The owner route: a block's image gradient (only when the prep's count is
// 0; otherwise the block does no setup and the scatter route behind it
// does the work), then, when the block holds every channel, the grid
// gradient of its cells' own pixels (the output has the image's size).
__global__ void __launch_bounds__(kBlock) bwd_owner(const float* __restrict__ img,
                                                    const float* __restrict__ grid,
                                                    const float* __restrict__ gout,
                                                    float* __restrict__ gimg,
                                                    float* __restrict__ ggrid,
                                                    const unsigned char* work, unsigned* flag,
                                                    Geom g, OwnerPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tx = blockIdx.x % p.tiles_x, ty = blockIdx.x / p.tiles_x;
  const int b0 = blockIdx.z * p.bpg, b1 = min(g.n, b0 + p.bpg);
  const int e = threadIdx.x;  // this thread's cell (cells <= blockDim)
  const int cx = tx * p.tw + e % p.tw, cy = ty * p.th + e / p.tw;
  const bool live = e < p.tw * p.th && cx < g.w && cy < g.h;
  // uniform over the launch: the prep's count says whether this route holds
  const bool do_img = gimg != nullptr && reinterpret_cast<const Meta*>(work)->count == 0;
  if (do_img) owner_image_grad(grid, gout, gimg, work, flag, g, p, smem, tx, ty, b0, b1, live);
  if (!ggrid || !p.fuse_grid || !live) return;
  for (int b = b0; b < b1; ++b) {
    const Corners k = corners_at(grid, g.shared ? 0 : b, cy, cx, g);
    const int rnw = nw_offset(k, g.img);
    const float* go_p = gout + b * g.gout.n + cy * g.gout.y + cx * g.gout.x;
    const float* ib = img + b * g.img.n;
    float gix = 0.0f, giy = 0.0f;
#pragma unroll 4
    for (int c = 0; c < g.c; ++c) {
      grid_terms(k, ib + c * g.img.c, rnw, g.img, __ldg(go_p + c * g.gout.c), gix, giy);
    }
    float* gg = ggrid + (((long long)b * g.ho + cy) * g.wo + cx) * 2;
    gg[0] = __fmul_rn(grid_mult(g.w, g.align), gix);
    gg[1] = __fmul_rn(grid_mult(g.h, g.align), giy);
  }
}

// The scatter route. Threads: pixel fastest, then lane (lanes split a
// pixel's channels), so that a warp reads one channel of 32 neighbouring
// pixels. The grid gradient's lane partials are folded by a fixed tree.
__global__ void __launch_bounds__(kBlock) bwd_scatter(const float* __restrict__ img,
                                                      const float* __restrict__ grid,
                                                      const float* __restrict__ gout,
                                                      unsigned long long* q,
                                                      const unsigned char* work,
                                                      float* __restrict__ ggrid, unsigned* flag,
                                                      Geom g, int lanes, int iters,
                                                      int predicated) {
  __shared__ float part[2][kBlock];
  const Meta* meta = reinterpret_cast<const Meta*>(work);
  const bool do_img = q != nullptr && !(predicated && meta->count == 0);
  if (!do_img && ggrid == nullptr) return;  // uniform over the launch
  const float scale = do_img ? meta->scale : 0.0f;
  const int per = kBlock / lanes, lane = threadIdx.x / per, slot = threadIdx.x % per;
  const int npix = g.n * g.ho * g.wo;
  for (int it = blockIdx.x; it < iters; it += gridDim.x) {  // uniform over the block
    const int pix = it * per + slot;
    float gix = 0.0f, giy = 0.0f;
    if (pix < npix && lane < g.c) {
      const int b = pix / (g.ho * g.wo), rem = pix - b * g.ho * g.wo;
      const int oy = rem / g.wo, ox = rem - oy * g.wo;
      const Corners k = corners_at(grid, g.shared ? 0 : b, oy, ox, g);
      const int rnw = nw_offset(k, g.img), qnw = nw_offset(k, g.out);
      const float* go_p = gout + b * g.gout.n + oy * g.gout.y + ox * g.gout.x;
      for (int c = lane; c < g.c; c += lanes) {
        const float go = __ldg(go_p + c * g.gout.c);
        if (do_img) {
          unsigned long long* qc = q + b * g.out.n + c * g.out.c + qnw;
          if (k.v[0]) fxp::add(qc, __fmul_rn(k.w[0], go), scale, flag);
          if (k.v[1]) fxp::add(qc + g.out.x, __fmul_rn(k.w[1], go), scale, flag);
          if (k.v[2]) fxp::add(qc + g.out.y, __fmul_rn(k.w[2], go), scale, flag);
          if (k.v[3]) fxp::add(qc + g.out.x + g.out.y, __fmul_rn(k.w[3], go), scale, flag);
        }
        if (ggrid) grid_terms(k, img + b * g.img.n + c * g.img.c, rnw, g.img, go, gix, giy);
      }
    }
    if (ggrid) {
      __syncthreads();
      part[0][threadIdx.x] = gix;
      part[1][threadIdx.x] = giy;
      __syncthreads();
      for (int s = lanes / 2; s > 0; s >>= 1) {  // a fixed tree over the pixel's lanes
        if (lane < s) {
          const int o = threadIdx.x + s * per;
          part[0][threadIdx.x] = __fadd_rn(part[0][threadIdx.x], part[0][o]);
          part[1][threadIdx.x] = __fadd_rn(part[1][threadIdx.x], part[1][o]);
        }
        __syncthreads();
      }
      if (lane == 0 && pix < npix) {
        ggrid[(long long)pix * 2] = __fmul_rn(grid_mult(g.w, g.align), part[0][threadIdx.x]);
        ggrid[(long long)pix * 2 + 1] = __fmul_rn(grid_mult(g.h, g.align), part[1][threadIdx.x]);
      }
    }
  }
}

cudaError_t launch_owner(const float* img, const float* grid, const float* gout, float* gimg,
                         float* ggrid, const unsigned char* work, unsigned* flag, const Geom& g,
                         const Args& a, cudaStream_t st) {
  const OwnerPlan p{(int)a.tw, (int)a.th, (int)a.tiles_x, (int)a.radius, (int)a.cpg,
                    (int)a.bpg, (int)a.fuse_grid, (int)a.owner_vec4};
  const long long cells = a.tw * a.th, hn = (a.tw + 2 * a.radius) * (a.th + 2 * a.radius);
  const long long smem = 32 * hn + 8 * cells + 4;
  // the planner's tiles keep a block under the 48 KB that needs no opt-in
  if (smem != a.smem || smem > 48 * 1024 || cells > kBlock || hn > 4096 ||
      (a.fuse_grid && a.cpg < a.c) ||
      (a.owner_vec4 && (a.c % 4 || a.cpg % 4 || a.gout[3] != 1 || a.out[3] != 1))) {
    return cudaErrorInvalidValue;
  }
  const dim3 blocks((unsigned)(a.tiles_x * a.tiles_y), (unsigned)a.cgroups, (unsigned)a.bgroups);
  bwd_owner<<<blocks, kBlock, (size_t)smem, st>>>(img, grid, gout, gimg, ggrid, work, flag, g, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out = grid_sample(img, grid), planned by ops/grid_sample.py. Returns
// cudaGetLastError().
int grid_sample_fwd(const float* img, const float* grid, float* out, const long long* args,
                    void* stream) {
  const Args& a = *reinterpret_cast<const Args*>(args);
  if (a.nfields != kFields) return (int)cudaErrorInvalidValue;
  const Geom g = geom(a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.fwd_blocks > 0) {
    if (a.fwd_packed) {
      fwd_packed4<<<(unsigned)a.fwd_blocks, kBlock, 0, st>>>(img, grid, out, g);
    } else {
      const dim3 blocks((unsigned)a.fwd_blocks, (unsigned)a.fwd_cgroups,
                        (unsigned)a.fwd_bgroups);
      fwd_pixels<<<blocks, kBlock, 0, st>>>(img, grid, out, g, (int)a.fwd_cpg, (int)a.fwd_bpg);
    }
  }
  return (int)cudaGetLastError();
}

// The gradients of grid_sample(img, grid) for the cotangent gout: gimg (when
// not null) and ggrid (when not null), planned by ops/grid_sample.py. work is
// the call's buffer (Meta, partials, counts); q the int64 table in gimg's
// layout (from torch.empty; only the scatter route touches it); sync two
// int32 of the stream (the prep's arrival count, kept 0 between calls, and
// the count of calls that fell back from the owner route); *launches gets
// the number of kernels launched. Returns the first CUDA error.
int grid_sample_bwd(const float* img, const float* grid, const float* gout, float* gimg,
                    float* ggrid, unsigned char* work, long long* q, int* sync, unsigned* flag,
                    const long long* args, int* launches, void* stream) {
  const Args& a = *reinterpret_cast<const Args*>(args);
  *launches = 0;
  if (a.nfields != kFields) return (int)cudaErrorInvalidValue;
  const Geom g = geom(a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (gimg) {
    const Flat4 f{{(int)a.gsz[0], (int)a.gsz[1], (int)a.gsz[2], (int)a.gsz[3]},
                  {(int)a.gst[0], (int)a.gst[1], (int)a.gst[2], (int)a.gst[3]}};
    bwd_prep<<<(unsigned)(a.nsum + a.ncnt), kBlock, 0, st>>>(
        gout, f, (int)(a.gsz[0] * a.gsz[1] * a.gsz[2] * a.gsz[3]), (int)a.nsum,
        (int)a.sum_chunk, grid, g, (int)a.radius, Tiles{(int)a.tw, (int)a.th}, (int)a.ncnt,
        work, sync);
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const bool owner = a.route == 1;
  if (owner) {
    err = launch_owner(img, grid, gout, gimg, ggrid, work, flag, g, a, st);
    ++*launches;
    if (err != cudaSuccess) return (int)err;
  }
  // the scatter route: unconditional for other shapes, predicated on the
  // prep's count behind the owner kernel
  float* sgrid = owner && a.fuse_grid ? nullptr : ggrid;
  auto* qs = gimg ? reinterpret_cast<unsigned long long*>(q) : nullptr;
  if (qs) {
    fxp::zero_table<<<(unsigned)a.tbl_blocks, kBlock, 0, st>>>(
        q, a.numel, owner ? reinterpret_cast<const int*>(work + 8) : nullptr);
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (qs || sgrid) {
    bwd_scatter<<<(unsigned)a.sc_blocks, kBlock, 0, st>>>(img, grid, gout, qs, work, sgrid, flag,
                                                           g, (int)a.sc_lanes, (int)a.sc_iters,
                                                           (int)owner);
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (qs) {
    err = fxp::launch_to_float<1>(q, gimg, (size_t)a.numel,
                                  reinterpret_cast<const float*>(work + 4), st,
                                  owner ? reinterpret_cast<const int*>(work + 8) : nullptr,
                                  (size_t)a.tbl_blocks);
    ++*launches;
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
