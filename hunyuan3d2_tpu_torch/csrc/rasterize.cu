// Z-buffer triangle rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hunyuan3d2_tpu/ops/rasterize_tpu.py
// `rasterize_tpu` -> `_kernel` (the pallas_call at :301, body :88-148).
// Same function: a pixel (x, y) at integer coordinates is covered by a face
// when its edge functions w0 = c0 + a0*x + b0*y, w1 = c1 + a1*x + b1*y and
// w2 = 1 - w0 - w1 are all >= 0 (either winding); its depth is
// z = clip(zc + w0*z0 + w1*z1, 0, 1); the nearest fp32 depth wins and a
// depth tie goes to the lowest face id. Outputs face_id (-1 where empty),
// (w0, w1, w2) and depth (0 where empty). The per-face records (screen
// transform, area, edge functions, bbox, culling) are computed by the
// Python wrapper in plain PyTorch, in the TPU kernel's fp32 order.
//
// Design. The TPU kernel bins faces to 128-pixel tiles and sweeps each
// tile's face list in ascending face order in VMEM, with static per-tile
// capacities that can overflow. Here nothing is binned and nothing has a
// capacity:
//  * pass 1, one thread per face, walks the face's clipped integer bbox and
//    does a 64-bit atomicMin of the token (float_bits(z) << 32 | face_id)
//    into a z-buffer. Depth lies in [0, 1] (-0 is folded to +0), where the
//    float bits order like the values, so the minimum token is exactly the
//    strict `z < best` sweep in ascending face order. Faces whose bbox holds
//    more than kBigPixels pixels are instead appended to a list and walked
//    by a whole block each in pass 1b, so a screen-sized face does not hold
//    one thread for millions of pixels.
//  * pass 2, one thread per pixel, decodes the token and recomputes w0, w1
//    of the winning face with the same formula.
// w0, w1, w2 and z are computed with __fmul_rn / __fadd_rn / __fsub_rn:
// no FMA contraction, so the coverage test rounds exactly as the TPU kernel
// and the plain PyTorch twin do, and edge pixels go to the same faces.
//
// What bounds it on the H100: at the paint path's sizes (about 40k faces,
// 512^2 cond maps, 2048^2 UV and bake rasters) it is bound by memory
// traffic: 8 bytes of z-buffer per pixel cleared, one 8-byte atomic per
// covered (face, pixel) pair, and 24 bytes of output per pixel; the
// arithmetic per pair is ~20 fp32 operations, far below the card's rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRec = 9;            // a0 b0 c0 a1 b1 c1 z0 z1 zc
constexpr int kBigPixels = 1024;   // bbox area above which a block walks the face
constexpr int kFaceThreads = 128;
constexpr int kBigThreads = 256;
constexpr int kBigBlocks = 264;    // 2 per SM
constexpr int kPixThreads = 256;
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ float edge(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(c, __fmul_rn(a, px)), __fmul_rn(b, py));
}

__device__ __forceinline__ void cover(const float* __restrict__ r, int f, int x, int y, int w,
                                      unsigned long long* __restrict__ zbuf) {
  const float px = (float)x, py = (float)y;
  const float w0 = edge(r[0], r[1], r[2], px, py);
  const float w1 = edge(r[3], r[4], r[5], px, py);
  const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
  if (!(w0 >= 0.f && w1 >= 0.f && w2 >= 0.f)) return;
  float z = __fadd_rn(__fadd_rn(r[8], __fmul_rn(w0, r[6])), __fmul_rn(w1, r[7]));
  if (z <= 0.f) z = 0.f;  // also folds -0 to +0
  if (z > 1.f) z = 1.f;
  if (!(z < 2.f)) return;  // NaN depth never covers (the TPU sweep's z < best)
  const unsigned long long token =
      ((unsigned long long)__float_as_uint(z) << 32) | (unsigned int)f;
  atomicMin(zbuf + (size_t)y * w + x, token);
}

__global__ void __launch_bounds__(kFaceThreads) raster_faces(
    const float* __restrict__ recs, const int4* __restrict__ bbox, int nf, int w,
    unsigned long long* __restrict__ zbuf, int* __restrict__ big, int* __restrict__ big_count) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nf) return;
  const int4 b = bbox[f];  // x0, x1, y0, y1; x0 > x1 for a culled face
  if (b.x > b.y || b.z > b.w) return;
  if ((long long)(b.y - b.x + 1) * (b.w - b.z + 1) > kBigPixels) {
    big[atomicAdd(big_count, 1)] = f;
    return;
  }
  float r[kRec];
#pragma unroll
  for (int i = 0; i < kRec; ++i) r[i] = recs[(size_t)f * kRec + i];
  for (int y = b.z; y <= b.w; ++y)
    for (int x = b.x; x <= b.y; ++x) cover(r, f, x, y, w, zbuf);
}

__global__ void __launch_bounds__(kBigThreads) raster_big_faces(
    const float* __restrict__ recs, const int4* __restrict__ bbox, int w,
    unsigned long long* __restrict__ zbuf, const int* __restrict__ big,
    const int* __restrict__ big_count) {
  const int n = *big_count;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int f = big[i];
    const int4 b = bbox[f];
    float r[kRec];
#pragma unroll
    for (int j = 0; j < kRec; ++j) r[j] = recs[(size_t)f * kRec + j];
    const int bw = b.y - b.x + 1;
    const long long count = (long long)bw * (b.w - b.z + 1);
    for (long long p = threadIdx.x; p < count; p += blockDim.x)
      cover(r, f, b.x + (int)(p % bw), b.z + (int)(p / bw), w, zbuf);
  }
}

__global__ void __launch_bounds__(kPixThreads) resolve(
    const float* __restrict__ recs, const unsigned long long* __restrict__ zbuf, int h, int w,
    int* __restrict__ face_id, float* __restrict__ bary, float* __restrict__ depth) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)h * w) return;
  const unsigned long long token = zbuf[p];
  if (token == kEmpty) {
    face_id[p] = -1;
    depth[p] = 0.f;
    bary[3 * p] = bary[3 * p + 1] = bary[3 * p + 2] = 0.f;
    return;
  }
  const int f = (int)(token & 0xffffffffu);
  const float* r = recs + (size_t)f * kRec;
  const float px = (float)(p % w), py = (float)(p / w);
  const float w0 = edge(r[0], r[1], r[2], px, py);
  const float w1 = edge(r[3], r[4], r[5], px, py);
  face_id[p] = f;
  depth[p] = __uint_as_float((unsigned int)(token >> 32));
  bary[3 * p] = w0;
  bary[3 * p + 1] = w1;
  bary[3 * p + 2] = __fsub_rn(__fsub_rn(1.f, w0), w1);
}

}  // namespace

// recs [nf, 9] float32 and bbox [nf, 4] int32 (x0, x1, y0, y1, clipped to
// the image; x0 > x1 marks a culled face) from the wrapper's face setup.
// zbuf [h*w] uint64 filled with ~0, big [nf] int32 scratch, big_count [1]
// int32 zeroed, all on the device. Writes face_id [h*w] int32, bary
// [h*w, 3] float32, depth [h*w] float32. Three launches in order on
// `stream`; returns the first cudaError_t (0 on success).
extern "C" int hy3d_rasterize(const float* recs, const int* bbox, int nf, int h, int w,
                              unsigned long long* zbuf, int* big, int* big_count, int* face_id,
                              float* bary, float* depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nf < 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int4* bb = reinterpret_cast<const int4*>(bbox);
  if (nf > 0) {
    raster_faces<<<(nf + kFaceThreads - 1) / kFaceThreads, kFaceThreads, 0, s>>>(
        recs, bb, nf, w, zbuf, big, big_count);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    raster_big_faces<<<kBigBlocks, kBigThreads, 0, s>>>(recs, bb, w, zbuf, big, big_count);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long npix = (long long)h * w;
  resolve<<<(unsigned int)((npix + kPixThreads - 1) / kPixThreads), kPixThreads, 0, s>>>(
      recs, zbuf, h, w, face_id, bary, depth);
  return (int)cudaGetLastError();
}
