// Copyright (c) ava256_tpu contributors.
// All rights reserved.
//
// This source code is licensed under the license found in the
// LICENSE file in the root directory of this source tree.
//
// 2D bilinear grid sampling with zeros padding, NHWC, for Hopper (sm_90a),
// plain C interface: the forward and a backward whose sums do not depend
// on the order the threads run in.
//
// Replaces F.grid_sample (mode="bilinear", padding_mode="zeros") on the
// card, whose backward adds into the image gradient with float atomics and
// has no deterministic form in PyTorch. It has no Pallas counterpart: the
// JAX package samples with XLA gathers (ava256_tpu/ops/grid_sample.py,
// packed or four-gather form). The port calls it from the identity
// encoder's warp of every bias-pyramid level (models/encoders/identity.py)
// and the geometry decoder's vertex sampling (models/decoders/geometry.py).
//
// Layout: img [N, H, W, C], grid [N, Ho, Wo, 2] ((x, y) in [-1, 1]), out
// [N, Ho, Wo, C], all float32 and contiguous. Source coordinates as
// PyTorch's grid_sampler_unnormalize: ((x + 1) W - 1) / 2, or (x + 1) / 2
// (W - 1) with align_corners; a corner outside the image reads zero. The
// products and sums are PyTorch's, in its order per channel.
//
// Threads: a block of 256 covers 256 / L output pixels, L = min(next power
// of two >= C, 256) lanes per pixel; lane l takes channels l, l + L, ...
// Neighbouring lanes read neighbouring channels of one corner cell.
//
//   forward   one gather of the four corner cells per output pixel.
//   backward  the image gradient: each (corner, channel) addend w * gout
//             goes into an int64 table in units of 2^-k with a 64-bit
//             integer atomic (fixed_point.cuh), so the sum is the same
//             whatever order the atomics land in; a second pass turns it
//             into float32. The scale comes from the sound bound
//             sum |gout| (a pixel's four weights sum to 1), so no sum can
//             leave int64 and no flag can be set. The grid gradient: each
//             lane sums its channels in order, the lanes of a pixel are
//             summed in shared memory by a fixed tree; no atomics.
//
// What bounds it: device-memory bytes (each output pixel reads its four
// corner cells, mostly from L2, and the backward's atomics go to L2); no
// matrix product, no reuse to stage in shared memory.

#include "fixed_point.cuh"

namespace {

constexpr int kBlock = 256;

struct Geom {
  int n, h, w, c, ho, wo, lanes, align;
};

struct Corners {
  int x0, y0;
  float ix, iy;
  float wnw, wne, wsw, wse;
  bool nw, ne, sw, se;
};

__device__ __forceinline__ float unnormalize(float x, int size, int align) {
  return align ? ((x + 1.0f) / 2.0f) * (float)(size - 1)
               : ((x + 1.0f) * (float)size - 1.0f) / 2.0f;
}

__device__ __forceinline__ bool inside(int x, int y, const Geom& g) {
  return x >= 0 && x < g.w && y >= 0 && y < g.h;
}

__device__ __forceinline__ Corners corners(const float* grid, size_t pix, const Geom& g) {
  Corners k;
  k.ix = unnormalize(grid[pix * 2], g.w, g.align);
  k.iy = unnormalize(grid[pix * 2 + 1], g.h, g.align);
  const float fx = floorf(k.ix), fy = floorf(k.iy);
  // weights as PyTorch's: nw = (x_se - x)(y_se - y), ne = (x - x_sw)(y_sw - y),
  // sw = (x_ne - x)(y - y_ne), se = (x - x_nw)(y - y_nw)
  k.wnw = ((fx + 1.0f) - k.ix) * ((fy + 1.0f) - k.iy);
  k.wne = (k.ix - fx) * ((fy + 1.0f) - k.iy);
  k.wsw = ((fx + 1.0f) - k.ix) * (k.iy - fy);
  k.wse = (k.ix - fx) * (k.iy - fy);
  // float -> int only where the value is in range; far samples read nothing
  const bool near = fx > -2.0f && fx < (float)g.w + 1.0f && fy > -2.0f && fy < (float)g.h + 1.0f;
  k.x0 = near ? (int)fx : -2;
  k.y0 = near ? (int)fy : -2;
  k.nw = near && inside(k.x0, k.y0, g);
  k.ne = near && inside(k.x0 + 1, k.y0, g);
  k.sw = near && inside(k.x0, k.y0 + 1, g);
  k.se = near && inside(k.x0 + 1, k.y0 + 1, g);
  return k;
}

__global__ void __launch_bounds__(kBlock) grid_sample_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ grid, float* __restrict__ out,
    Geom g) {
  const int lane = threadIdx.x % g.lanes;
  const size_t pix = (size_t)blockIdx.x * (kBlock / g.lanes) + threadIdx.x / g.lanes;
  const size_t npix = (size_t)g.n * g.ho * g.wo;
  if (pix >= npix || lane >= g.c) return;
  const size_t b = pix / ((size_t)g.ho * g.wo);
  const Corners k = corners(grid, pix, g);
  const float* base = img + b * g.h * g.w * g.c;
  const long long rnw = ((long long)k.y0 * g.w + k.x0) * g.c,
                  rsw = rnw + (long long)g.w * g.c;  // a corner may sit at -1
  for (int c = lane; c < g.c; c += g.lanes) {
    float acc = 0.0f;
    if (k.nw) acc = acc + base[rnw + c] * k.wnw;
    if (k.ne) acc = acc + base[rnw + g.c + c] * k.wne;
    if (k.sw) acc = acc + base[rsw + c] * k.wsw;
    if (k.se) acc = acc + base[rsw + g.c + c] * k.wse;
    out[pix * g.c + c] = acc;
  }
}

__global__ void __launch_bounds__(kBlock) grid_sample_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ grid,
    const float* __restrict__ gout, unsigned long long* qimg, const float* scale_p,
    float* __restrict__ ggrid, unsigned* flag, Geom g) {
  __shared__ float part[2][kBlock];
  const int lane = threadIdx.x % g.lanes;
  const size_t pix = (size_t)blockIdx.x * (kBlock / g.lanes) + threadIdx.x / g.lanes;
  const size_t npix = (size_t)g.n * g.ho * g.wo;
  float gix = 0.0f, giy = 0.0f;
  if (pix < npix && lane < g.c) {
    const float scale = qimg ? *scale_p : 0.0f;
    const size_t b = pix / ((size_t)g.ho * g.wo);
    const Corners k = corners(grid, pix, g);
    const size_t off = b * g.h * g.w * g.c;
    const float* base = img + off;
    unsigned long long* qbase = qimg ? qimg + off : nullptr;
    const long long rnw = ((long long)k.y0 * g.w + k.x0) * g.c,
                  rsw = rnw + (long long)g.w * g.c;  // a corner may sit at -1
    const float x_sw = (float)k.x0, y_sw = (float)(k.y0 + 1);  // as PyTorch names them
    const float x_ne = (float)(k.x0 + 1), y_ne = (float)k.y0;
    const float x_nw = (float)k.x0, y_nw = (float)k.y0;
    const float x_se = (float)(k.x0 + 1), y_se = (float)(k.y0 + 1);
    for (int c = lane; c < g.c; c += g.lanes) {
      const float go = gout[pix * g.c + c];
      if (qbase) {
        if (k.nw) fxp::add(qbase + rnw + c, k.wnw * go, scale, flag);
        if (k.ne) fxp::add(qbase + rnw + g.c + c, k.wne * go, scale, flag);
        if (k.sw) fxp::add(qbase + rsw + c, k.wsw * go, scale, flag);
        if (k.se) fxp::add(qbase + rsw + g.c + c, k.wse * go, scale, flag);
      }
      if (ggrid) {
        if (k.nw) {
          const float v = base[rnw + c];
          gix = gix - v * (y_se - k.iy) * go;
          giy = giy - v * (x_se - k.ix) * go;
        }
        if (k.ne) {
          const float v = base[rnw + g.c + c];
          gix = gix + v * (y_sw - k.iy) * go;
          giy = giy - v * (k.ix - x_sw) * go;
        }
        if (k.sw) {
          const float v = base[rsw + c];
          gix = gix - v * (k.iy - y_ne) * go;
          giy = giy + v * (x_ne - k.ix) * go;
        }
        if (k.se) {
          const float v = base[rsw + g.c + c];
          gix = gix + v * (k.iy - y_nw) * go;
          giy = giy + v * (k.ix - x_nw) * go;
        }
      }
    }
  }
  if (!ggrid) return;  // uniform over the launch
  part[0][threadIdx.x] = gix;
  part[1][threadIdx.x] = giy;
  __syncthreads();
  for (int s = g.lanes / 2; s > 0; s >>= 1) {  // a fixed tree over the pixel's lanes
    if (lane < s) {
      part[0][threadIdx.x] += part[0][threadIdx.x + s];
      part[1][threadIdx.x] += part[1][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (lane == 0 && pix < npix) {
    const float mx = g.align ? (float)(g.w - 1) / 2.0f : (float)g.w / 2.0f;
    const float my = g.align ? (float)(g.h - 1) / 2.0f : (float)g.h / 2.0f;
    ggrid[pix * 2] = mx * part[0][threadIdx.x];
    ggrid[pix * 2 + 1] = my * part[1][threadIdx.x];
  }
}

Geom make_geom(int n, int h, int w, int c, int ho, int wo, int align) {
  int lanes = 1;
  while (lanes < c && lanes < kBlock) lanes *= 2;
  return Geom{n, h, w, c, ho, wo, lanes, align};
}

unsigned grid_blocks(const Geom& g) {
  const size_t per = kBlock / g.lanes;
  return (unsigned)(((size_t)g.n * g.ho * g.wo + per - 1) / per);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out = grid_sample(img, grid). Returns cudaGetLastError().
int grid_sample_fwd(const float* img, const float* grid, float* out, int n, int h, int w, int c,
                    int ho, int wo, int align, void* stream) {
  const Geom g = make_geom(n, h, w, c, ho, wo, align);
  const unsigned blocks = grid_blocks(g);
  if (blocks > 0) {
    grid_sample_fwd_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        img, grid, out, g);
  }
  return (int)cudaGetLastError();
}

// The gradients of grid_sample(img, grid) for the cotangent gout: gimg
// (when not null) through the int64 table qimg (zeroed by the caller) at
// *scale, turned into float32 with *inv_scale; ggrid (when not null).
// Returns the first CUDA error of the launches.
int grid_sample_bwd(const float* img, const float* grid, const float* gout, long long* qimg,
                    const float* scale, const float* inv_scale, float* gimg, float* ggrid,
                    unsigned* flag, int n, int h, int w, int c, int ho, int wo, int align,
                    void* stream) {
  const Geom g = make_geom(n, h, w, c, ho, wo, align);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = grid_blocks(g);
  auto* q = gimg ? reinterpret_cast<unsigned long long*>(qimg) : nullptr;
  if (blocks > 0) {
    grid_sample_bwd_kernel<<<blocks, kBlock, 0, st>>>(img, grid, gout, q, scale, ggrid, flag, g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !gimg) return (int)err;
  return (int)fxp::launch_to_float(qimg, gimg, (size_t)n * h * w * c, inv_scale, 1, st);
}

}  // extern "C"
