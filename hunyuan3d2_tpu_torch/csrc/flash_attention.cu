// Non-causal flash attention for Hopper (sm_90a), bf16 and fp32, without
// or with a boolean mask.
//
// Replaces the Pallas TPU kernels hunyuan3d2_tpu/ops/flash_attention.py
// `flash_attention` -> `_flash` -> `_kernel` (the pallas_call at :221) and
// `flash_attention_masked` -> `_flash_masked` -> `_kernel_masked` (the
// pallas_call at :159, body :90-134).
// Same function: the scale is folded into q in fp32 and rounded back to the
// input dtype before the product; softmax state (running max, normaliser)
// and the accumulator are fp32; p is rounded to the input dtype before the
// P.V product; key columns past Lk are masked to -1e30; the output is
// acc / max(l, 1e-30) in the input dtype.
//
// The masked form takes a [B, Lq, Lk] uint8 mask shared across the H heads
// (batch index bh / H), as the paint UNet's voxel-locality multiview mask
// is. Where the mask is 0 the score is set to -1e30 AND p is forced to 0,
// as the TPU kernel does (:118-123): a row whose first key tiles are all
// masked cannot leak exp(0) weights while its running max is still -1e30,
// and a fully masked row ends with l = 0 and an output of 0. Each 64x64
// mask tile is staged in shared memory (row stride Lk in device memory,
// rows padded to 80 bytes in shared memory so the fragment reads are free
// of bank conflicts); the extra traffic is 1 byte per score against the
// 2*D*2 bytes of K/V per key, so the masked kernel stays compute-bound at
// the paint shapes ([1,10,6144,64], [1,20,1536,64]). Fully masked key tiles
// are still computed (skipping them is later work).
//
// What bounds it on the H100: at the shapes of the image->mesh path
// (DINOv2 [1,24,1370,64], DiT [2,16,1882,64], both bf16) attention is
// compute-bound: 4*L^2*D operations against 4*L*D*2 bytes moved, far above
// the card's ~295 operations per byte. The score matrix never touches
// device memory.
//
// Design (a simple, correct first version; wgmma/TMA/warp specialisation
// are later work):
//  * bf16: one CTA of 4 warps per (batch*head, 64-row q tile). Each warp
//    owns 16 q rows and keeps their A fragments in registers for the whole
//    key loop. K/V tiles of 64 keys are staged in shared memory (rows padded
//    by 8 elements so fragment loads are free of bank conflicts). Both
//    products run on the tensor cores with mma.sync.m16n8k16 (bf16 inputs,
//    fp32 accumulate); the score fragments are re-packed in registers as the
//    A operand of the P.V product (no shared-memory round trip), and the
//    online softmax runs on the fragments with quad shuffles.
//  * fp32: the VAE self-attention runs in fp32 at L=512 (16 launches per
//    image, ~1 GFLOP each). It uses plain FMA (no TF32, which would lose
//    precision): one thread per q row, scores for a 32-key tile in shared
//    memory, online softmax per tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;   // q rows per CTA (4 warps x 16)
constexpr int kBK = 64;   // keys per shared-memory tile

// Copy rows [r0, r0+64) x D of a row-major [len, D] bf16 matrix into shared
// memory with row stride LDS, zero-filling rows >= len. With kScale the
// values are multiplied by `scale` in fp32 and rounded back to bf16.
template <int D, int LDS, bool kScale>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int len, float scale) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBK * kChunks; i += blockDim.x) {
    const int row = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + row < len) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * D + c * 8);
      if (kScale) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + row * LDS + c * 8) = val;
  }
}

constexpr int kLDM = 80;  // shared-memory row stride of a mask tile, bytes

// Copy the [64 q rows, 64 keys] tile at (q0, kt) of one batch's row-major
// [lq, lk] uint8 mask into shared memory, 0 outside [lq, lk). Rows start at
// arbitrary byte offsets (stride lk), so 16-byte loads are used only when lk
// is a multiple of 16.
__device__ __forceinline__ void load_mask_tile(uint8_t* dst, const uint8_t* src, int q0, int kt,
                                               int lq, int lk) {
  if ((lk & 15) == 0 && kt + kBK <= lk) {
    for (int i = threadIdx.x; i < kBQ * (kBK / 16); i += blockDim.x) {
      const int row = i / (kBK / 16), c = i % (kBK / 16);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (q0 + row < lq)
        val = *reinterpret_cast<const uint4*>(src + (size_t)(q0 + row) * lk + kt + c * 16);
      *reinterpret_cast<uint4*>(dst + row * kLDM + c * 16) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kBQ * kBK; i += blockDim.x) {
      const int row = i / kBK, col = i % kBK;
      dst[row * kLDM + col] =
          (q0 + row < lq && kt + col < lk) ? src[(size_t)(q0 + row) * lk + kt + col] : 0;
    }
  }
}

template <int D, bool kMask>
__global__ void __launch_bounds__(128) flash_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ o, int heads, int lq, int lk, float scale) {
  constexpr int LDS = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * LDS];
  __shared__ __align__(16) uint8_t Ms[kMask ? kBQ * kLDM : 16];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * lq * D;
  k += (size_t)bh * lk * D;
  v += (size_t)bh * lk * D;
  o += (size_t)bh * lq * D;
  if (kMask) mask += (size_t)(bh / heads) * lq * lk;

  // q tile (scaled, rounded to bf16) through Ks, then into A fragments
  load_tile<D, LDS, true>(Ks, q, q0, lq, scale);
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qw = Ks + warp * 16 * LDS;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = lds32(qw + g * LDS + kk * 16 + 2 * t);
      qa[kk][1] = lds32(qw + (g + 8) * LDS + kk * 16 + 2 * t);
      qa[kk][2] = lds32(qw + g * LDS + kk * 16 + 2 * t + 8);
      qa[kk][3] = lds32(qw + (g + 8) * LDS + kk * 16 + 2 * t + 8);
    }
  }
  __syncthreads();

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g, g+8
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = 0; kt < lk; kt += kBK) {
    load_tile<D, LDS, false>(Ks, k, kt, lk, 0.f);
    load_tile<D, LDS, false>(Vs, v, kt, lk, 0.f);
    if (kMask) load_mask_tile(Ms, mask, q0, kt, lq, lk);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16_16816(s[nt], qa[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }
    // allowed[nt] bits 0..3 mark s[nt][0..3]; the mask tile is 0 past lk
    uint32_t allowed[kBK / 8];
    if (kMask) {
      const uint8_t* m0r = Ms + (warp * 16 + g) * kLDM + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const uint16_t a = *reinterpret_cast<const uint16_t*>(m0r + nt * 8);
        const uint16_t b = *reinterpret_cast<const uint16_t*>(m0r + 8 * kLDM + nt * 8);
        allowed[nt] = ((a & 0xff) ? 1u : 0u) | ((a >> 8) ? 2u : 0u) | ((b & 0xff) ? 4u : 0u) |
                      ((b >> 8) ? 8u : 0u);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!(allowed[nt] >> e & 1u)) s[nt][e] = kNegInf;
      }
    } else if (kt + kBK > lk) {  // ragged last tile: mask padded key columns
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const int col = kt + nt * 8 + 2 * t;
        if (col >= lk) s[nt][0] = s[nt][2] = kNegInf;
        if (col + 1 >= lk) s[nt][1] = s[nt][3] = kNegInf;
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx0);
      s[nt][1] = expf(s[nt][1] - mx0);
      s[nt][2] = expf(s[nt][2] - mx1);
      s[nt][3] = expf(s[nt][3] - mx1);
      if (kMask) {  // p = 0 where masked, even while the running max is -1e30
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!(allowed[nt] >> e & 1u)) s[nt][e] = 0.f;
      }
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha0;
      acc[dn][1] *= alpha0;
      acc[dn][2] *= alpha1;
      acc[dn][3] *= alpha1;
    }
    // P.V: the score fragments of two adjacent 8-key tiles form the A
    // fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = Vs + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vp = vr + dn * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LDS]);
        const uint32_t b1 = pack_raw(vp[8 * LDS], vp[9 * LDS]);
        mma_bf16_16816(acc[dn], pa, b0, b1);
      }
    }
    m0 = mx0;
    m1 = mx1;
    __syncthreads();
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r0 < lq)
      *reinterpret_cast<uint32_t*>(o + (size_t)r0 * D + col) =
          pack_bf16(acc[dn][0] / d0, acc[dn][1] / d0);
    if (r1 < lq)
      *reinterpret_cast<uint32_t*>(o + (size_t)r1 * D + col) =
          pack_bf16(acc[dn][2] / d1, acc[dn][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// fp32, plain FMA
// ---------------------------------------------------------------------------
constexpr int kRowsF32 = 64;  // q rows per CTA, one thread each
constexpr int kBKF32 = 32;    // keys per tile

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         ((size_t)kRowsF32 * (D + 1) + 2 * (size_t)kBKF32 * D + (size_t)kRowsF32 * (kBKF32 + 1));
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kRowsF32) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ mask, float* __restrict__ o, int heads, int lq, int lk,
    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                            // [64][D+1]
  float* Ks = Qs + kRowsF32 * (D + 1);         // [32][D]
  float* Vs = Ks + kBKF32 * D;                 // [32][D]
  float* Ss = Vs + kBKF32 * D;                 // [64][33]

  const int bh = blockIdx.y, q0 = blockIdx.x * kRowsF32, r = threadIdx.x;
  q += (size_t)bh * lq * D;
  k += (size_t)bh * lk * D;
  v += (size_t)bh * lk * D;
  o += (size_t)bh * lq * D;
  // this thread's mask row (rows past lq read nothing: their keys all count
  // as masked, and their output is not written)
  const uint8_t* mrow = nullptr;
  if (kMask && q0 + r < lq) mrow = mask + ((size_t)(bh / heads) * lq + q0 + r) * lk;

  for (int i = threadIdx.x; i < kRowsF32 * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    Qs[row * (D + 1) + c] = (q0 + row < lq) ? q[(size_t)(q0 + row) * D + c] * scale : 0.f;
  }
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;
  const float* qr = Qs + r * (D + 1);
  float* sr = Ss + r * (kBKF32 + 1);

  for (int kt = 0; kt < lk; kt += kBKF32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBKF32 * D; i += blockDim.x) {
      const int row = i / D;
      const bool ok = kt + row < lk;
      Ks[i] = ok ? k[(size_t)kt * D + i] : 0.f;
      Vs[i] = ok ? v[(size_t)kt * D + i] : 0.f;
    }
    __syncthreads();
    float mx = m;
    for (int j = 0; j < kBKF32; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], Ks[j * D + d], s);
      if (kt + j >= lk || (kMask && (mrow == nullptr || !mrow[kt + j]))) s = kNegInf;
      sr[j] = s;
      mx = fmaxf(mx, s);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    for (int j = 0; j < kBKF32; ++j) {
      float p = expf(sr[j] - mx);
      if (kMask && (kt + j >= lk || mrow == nullptr || !mrow[kt + j])) p = 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j * D + d], acc[d]);
    }
    m = mx;
  }
  if (q0 + r < lq) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = o + (size_t)(q0 + r) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / den;
  }
}

template <int D, bool kMask>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const uint8_t* mask,
                       float* o, int n, int heads, int lq, int lk, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D, kMask>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + kRowsF32 - 1) / kRowsF32, n);
  flash_f32_kernel<D, kMask><<<grid, kRowsF32, smem, stream>>>(q, k, v, mask, o, heads, lq, lk,
                                                               scale);
  return cudaGetLastError();
}

template <int D, bool kMask>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const uint8_t* mask,
                        void* o, int n, int heads, int lq, int lk, float scale,
                        cudaStream_t stream) {
  dim3 grid((lq + kBQ - 1) / kBQ, n);
  flash_bf16_kernel<D, kMask><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(o), heads, lq,
      lk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* o,
                   int n, int heads, int lq, int lk, int dtype, float scale, cudaStream_t s) {
  if (dtype == 0) {
    return mask ? launch_bf16<D, true>(q, k, v, mask, o, n, heads, lq, lk, scale, s)
                : launch_bf16<D, false>(q, k, v, mask, o, n, heads, lq, lk, scale, s);
  }
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  return mask ? launch_f32<D, true>(qf, kf, vf, mask, of, n, heads, lq, lk, scale, s)
              : launch_f32<D, false>(qf, kf, vf, mask, of, n, heads, lq, lk, scale, s);
}

}  // namespace

// q [n, lq, d], k/v [n, lk, d], o [n, lq, d], all contiguous on the device,
// n = B * heads. mask is NULL (unmasked) or a contiguous [B, lq, lk] uint8
// array (nonzero = attend) shared across the heads. dtype 0 = bf16,
// 1 = fp32; d in {64, 128}. Returns the cudaError_t of the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int hy3d_flash_attention(const void* q, const void* k, const void* v, const void* mask,
                                    void* o, int n, int heads, int lq, int lk, int d, int dtype,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (n <= 0 || heads <= 0 || n % heads != 0 || lq <= 0 || lk <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (d == 64) return (int)launch<64>(q, k, v, m, o, n, heads, lq, lk, dtype, scale, s);
  if (d == 128) return (int)launch<128>(q, k, v, m, o, n, heads, lq, lk, dtype, scale, s);
  return (int)cudaErrorInvalidValue;
}
