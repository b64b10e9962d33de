// The backward of kernel 1 (non-causal flash attention, unmasked) for Hopper
// (sm_90a), bf16 and fp32, D in {64, 128}.
//
// What it replaces: the gradient of hunyuan3d2_tpu/ops/flash_attention.py
// `flash_attention` (the pallas_call at :221). The TPU kernel had no
// backward: the JAX package's training differentiates the plain XLA
// attention (ops/attention.py `sdpa`), and the port's autograd wrapper
// recomputed the plain twin under autograd, holding [B, H, Lq, Lk] fp32
// scores several times over. This file computes the gradient of the
// kernel's own function (ops/flash_attention.py `flash_attention_plain`)
// from q, k, v, the forward's output o, its row log-sum-exp lse (the kLse
// forward instance, flash_attention.cuh) and dO, and keeps no scores in
// device memory:
//   qs = rnd(q * scale) (the q the products use), P = exp(qs k^T - lse),
//   dV = rnd(P)^T dO, dP = dO v^T, delta = rowsum(dO o), dS = P (dP - delta),
//   dK = rnd(dS)^T qs, dq = scale * (rnd(dS) k) (straight through the
//   rounding of qs, as the plain autograd), where rnd rounds to the input
//   dtype (the tensor cores' operand type); outputs in the input dtype.
//
// What bounds it on the H100: a forward and a backward that keep no scores
// need 12 B H Lq Lk D operations (Q K^T, P V; then dV, dP, dQ, dK; the
// backward alone 10, since it must recompute S once) against (4 Lq + 4 Lk) D
// elements moved per head, so every shape on the port's paths is
// compute-bound (989 TFLOP/s bf16; the fp32 rows, held to fp32-grade error,
// run 3xTF32 products on the 495 TFLOP/s TF32 tensor cores at three
// products a pair). This design's backward does 14: both passes recompute
// S and the dQ pass recomputes dP (18 with the forward against the bound's
// 12), so it sits above the bound by design. It buys determinism: no pass
// sums into memory with atomics, so two runs give the same bits (the
// training path's resume check holds two runs of the same steps to 1e-5).
//
// Design:
//  * a pre-pass (one warp a row) writes qs, delta = rowsum(dO o) and
//    lse * log2(e), the last two padded to a multiple of 64 rows (padded
//    rows: delta 0, lse +inf, so their P is exactly 0);
//  * the dK/dV pass: one CTA of 4 warps per 64-key tile (16 keys a warp),
//    K and V resident in shared memory, walking q tiles of BQ rows that
//    cp.async double-buffers (qs, dO, lse, delta). Per tile each warp
//    computes S^T = K qs^T, P^T in registers, dV += rnd(P^T) dO,
//    dP^T = V dO^T, dS^T, dK += rnd(dS^T) qs; the accumulators turn into
//    the next product's A operand in registers. Where B H ceil(Lk/64) CTAs
//    would leave SMs idle (the decode chunk: 16 x 8 = 128 CTAs walking 2,048
//    q tiles each), the q range is split over `splits` CTAs per key tile
//    that write fp32 partial sums; a second kernel adds them in split order
//    and rounds once;
//  * the dQ pass: one CTA of 4 warps per 64-row q tile (qs and dO resident),
//    walking 64-key tiles of K and V double-buffered: S = qs K^T, P (padded
//    keys 0), dP = dO V^T, dS, dQ += rnd(dS) K; dq = scale * dQ, rounded once;
//  * bf16: mma.sync.m16n8k16 with ldmatrix (.trans for the row-major B of
//    dS.K, P^T.dO and dS^T.qs), rows padded by 16 bytes (conflict-free);
//    exponentials with ex2 and lse pre-multiplied by log2(e);
//  * fp32: the same passes on mma.sync.m16n8k8.tf32 as 3xTF32 split
//    products (big.big + big.small + small.big), the forward's fp32 scheme;
//    each q tile's (dK/dV pass) or key tile's (dQ pass) products are summed
//    in fresh accumulators and added to the running sums in fp32, so no
//    tensor-core accumulator is carried across tiles (its truncation would
//    grow with the sequence; flash_attention.cu's note).
#include "flash_attention.cuh"  // hopper.cuh, and the forward's kLog2e and kMaxSmem

namespace {
namespace fbwd {

using namespace hopper;
using bf16 = __nv_bfloat16;
using flash::kLog2e;
using flash::kMaxSmem;

constexpr int kKeysPerCta = 64;  // dK/dV pass: 4 warps x 16 keys
constexpr int kRowsPerCta = 64;  // dQ pass: 4 warps x 16 q rows
constexpr int kPad = 64;         // lse / delta rows are padded to a multiple of this

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// ---------------------------------------------------------------------------
// pre-pass: qs, delta, lse * log2(e)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(256)
    prep_kernel(const T* __restrict__ q, const T* __restrict__ o, const T* __restrict__ dout,
                const float* __restrict__ lse, T* __restrict__ qs, float* __restrict__ delta,
                float* __restrict__ lse2, int lq, int lq_pad, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, row = blockIdx.x * 8 + warp;
  if (row >= lq_pad) return;
  const size_t srow = (size_t)bh * lq_pad + row;
  if (row >= lq) {
    if (lane == 0) {
      delta[srow] = 0.f;
      lse2[srow] = __int_as_float(0x7f800000);  // +inf: P = 0
    }
    return;
  }
  const size_t off = ((size_t)bh * lq + row) * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) {
    acc = fmaf(to_f(dout[off + c]), to_f(o[off + c]), acc);
    qs[off + c] = from_f<T>(to_f(q[off + c]) * scale);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    delta[srow] = acc;
    lse2[srow] = lse[(size_t)bh * lq + row] * kLog2e;
  }
}

// ---------------------------------------------------------------------------
// bf16 warp products: mma.sync m16n8k16, operands by ldmatrix
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16 x 8 NT] += A . Bt^T: A [16 x 16 KS] and Bt [8 NT x 16 KS] row-major in
// shared memory (row strides lda, ldb elements). Accumulator c[j][e] holds
// row g + 8 (e / 2), column 8 j + 2 t + (e % 2) (g = lane / 4, t = lane % 4).
template <int KS, int NT>
__device__ __forceinline__ void mma16_abt(float (&c)[NT][4], const bf16* a, int lda, const bf16* b,
                                          int ldb) {
  const int lane = threadIdx.x % 32;
  const bf16* ar = a + (lane % 16) * lda + (lane / 16) * 8;
  const bf16* br = b + ((lane % 8) + (lane / 16) * 8) * ldb + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, ar + ks * 16);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t bf[4];
      ldsm_x4(bf, br + j * 16 * ldb + ks * 16);
      mma_bf16(c[2 * j], af, bf[0], bf[1]);
      mma_bf16(c[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

// c[16 x 8 NT] += A . B: A as KS register fragments (a 16 x 16 KS tile), B
// [16 KS x 8 NT] row-major in shared memory (row stride ldb), read by
// ldmatrix.trans.
template <int KS, int NT>
__device__ __forceinline__ void mma16_ab(float (&c)[NT][4], const uint32_t (&a)[KS][4],
                                         const bf16* b, int ldb) {
  const int lane = threadIdx.x % 32;
  const bf16* br = b + (lane % 16) * ldb + (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t bf[4];
      ldsm_x4_t(bf, br + ks * 16 * ldb + j * 16);
      mma_bf16(c[2 * j], a[ks], bf[0], bf[1]);
      mma_bf16(c[2 * j + 1], a[ks], bf[2], bf[3]);
    }
  }
}

// An accumulator [16 x 8 NT] as the bf16 A fragments of a product over its
// columns: k step kk takes columns 16 kk .. 16 kk + 15 (tiles 2 kk, 2 kk + 1).
template <int NT>
__device__ __forceinline__ void to_a16(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// ---------------------------------------------------------------------------
// fp32 warp products: 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                     float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32_1688(d, as, bb0, bb1);
  mma_tf32_1688(d, ab, bs0, bs1);
  mma_tf32_1688(d, ab, bb0, bb1);
}

// c[16 x 8 NT] += A . Bt^T, A [16 x 8 KS] and Bt [8 NT x 8 KS] row-major in
// shared memory (row strides lda, ldb floats); the accumulator layout of
// mma16_abt.
template <int KS, int NT>
__device__ __forceinline__ void mma32_abt(float (&c)[NT][4], const float* a, int lda, const float* b,
                                          int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ab[4], as[4];
    split_tf32(a[g * lda + 8 * ks + t], ab[0], as[0]);
    split_tf32(a[(g + 8) * lda + 8 * ks + t], ab[1], as[1]);
    split_tf32(a[g * lda + 8 * ks + t + 4], ab[2], as[2]);
    split_tf32(a[(g + 8) * lda + 8 * ks + t + 4], ab[3], as[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* br = b + (8 * nt + g) * ldb + 8 * ks + t;
      mma3(c[nt], ab, as, br[0], br[4]);
    }
  }
}

// c[16 x 8 NT] += X . B: X an accumulator [16 x 8 KS] taken over its columns,
// B [8 KS x 8 NT] row-major in shared memory at b (row stride ldb). The 8 keys of each step are permuted (logical k = t
// holds column 2 t, k = t + 4 column 2 t + 1), so X's fragment is the A
// fragment as it stands; B's rows follow the same permutation.
template <int KS, int NT>
__device__ __forceinline__ void mma32_xb(float (&c)[NT][4], const float (&x)[KS][4], const float* b,
                                         int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(x[kk][0], ab[0], as[0]);
    split_tf32(x[kk][2], ab[1], as[1]);
    split_tf32(x[kk][1], ab[2], as[2]);
    split_tf32(x[kk][3], ab[3], as[3]);
    const float* br = b + (8 * kk + 2 * t) * ldb + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma3(c[nt], ab, as, br[8 * nt], br[ldb + 8 * nt]);
  }
}

// acc += X . B over all D columns, each 64-column block summed in fresh
// accumulators first (NB = D / 8 column tiles of acc).
template <int KS, int NB>
__device__ __forceinline__ void add_xb_fresh(float (&acc)[NB][4], const float (&x)[KS][4],
                                             const float* b, int ldb) {
#pragma unroll
  for (int h = 0; h < NB / 8; ++h) {
    float part[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
    mma32_xb<KS, 8>(part, x, b + 64 * h, ldb);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[8 * h + i][e] += part[i][e];
  }
}

// ---------------------------------------------------------------------------
// The two passes, one template per dtype family
// ---------------------------------------------------------------------------
template <typename T>
struct Traits;
template <>
struct Traits<bf16> {
  static constexpr int kRowPad = 8;  // 16 bytes
};
template <>
struct Traits<float> {
  static constexpr int kRowPad = 4;  // 16 bytes
};

template <typename T, int D>
__device__ __forceinline__ void async_rows(T* dst, const T* src, int rows, int row0, int nrows) {
  constexpr int kLd = D + Traits<T>::kRowPad;
  constexpr int kChunks = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = e % kChunks, row = row0 + r;
    const bool ok = row < nrows;
    cp_async16(reinterpret_cast<uint8_t*>(dst + r * kLd) + 16 * c,
               reinterpret_cast<const uint8_t*>(src + (ok ? (size_t)row * D : 0)) + 16 * c, ok);
  }
}

__device__ __forceinline__ void async_floats(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n / 4; e += blockDim.x) cp_async16(dst + 4 * e, src + 4 * e, true);
}

// P = exp2(s * log2 e - lse2); `ex2` (SFU) for bf16, exp2f for fp32.
template <typename T>
__device__ __forceinline__ float prob(float s, float lse2) {
  if constexpr (sizeof(T) == 2)
    return ex2(fmaf(s, kLog2e, -lse2));
  else
    return exp2f(fmaf(s, kLog2e, -lse2));
}

template <typename T, int D, int BQ>
struct KvCfg {
  static constexpr int kLd = D + Traits<T>::kRowPad;
  static constexpr size_t kSmem =
      sizeof(T) * (size_t)(2 * kKeysPerCta * kLd + 4 * BQ * kLd) + 4 * sizeof(float) * BQ;
};

// dK/dV pass: grid (ceil(lk / 64), n, splits). Split z walks q tiles
// [z * per, min(nqt, (z + 1) * per)); with part == nullptr (one split) it
// writes dk, dv in T, else fp32 partial sums part[0 or 1][z][bh][key][d].
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(128)
    dkdv_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ qs,
                const T* __restrict__ dout, const float* __restrict__ lse2,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ part, int n, int lq, int lk, int lq_pad, int per) {
  using C = KvCfg<T, D, BQ>;
  constexpr int kLd = C::kLd;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem_bwd[];
  T* Ks = reinterpret_cast<T*>(smem_bwd);
  T* Vs = Ks + kKeysPerCta * kLd;
  T* Qs = Vs + kKeysPerCta * kLd;  // [2][BQ][kLd]
  T* Os = Qs + 2 * BQ * kLd;       // [2][BQ][kLd]
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * kLd);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                  // [2][BQ]

  const int bh = blockIdx.y, k0 = blockIdx.x * kKeysPerCta, z = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4, g = lane / 4;
  const int nqt = (lq + BQ - 1) / BQ;
  const int it0 = z * per, it1 = min(nqt, it0 + per);
  k += (size_t)bh * lk * D;
  v += (size_t)bh * lk * D;
  qs += (size_t)bh * lq * D;
  dout += (size_t)bh * lq * D;
  lse2 += (size_t)bh * lq_pad;
  delta += (size_t)bh * lq_pad;

  async_rows<T, D>(Ks, k, kKeysPerCta, k0, lk);
  async_rows<T, D>(Vs, v, kKeysPerCta, k0, lk);
  auto load = [&](int it, int b) {
    async_rows<T, D>(Qs + b * BQ * kLd, qs, BQ, it * BQ, lq);
    async_rows<T, D>(Os + b * BQ * kLd, dout, BQ, it * BQ, lq);
    async_floats(Ls + b * BQ, lse2 + it * BQ, BQ);
    async_floats(Ds + b * BQ, delta + it * BQ, BQ);
  };
  if (it0 < it1) load(it0, 0);
  cp_async_commit();

  constexpr int NT = BQ / 8;  // q columns of S^T, in 8-column tiles
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  const T* kw = Ks + 16 * warp * kLd;
  const T* vw = Vs + 16 * warp * kLd;

  for (int it = it0; it < it1; ++it) {
    const int b = (it - it0) & 1;
    if (it + 1 < it1) {
      load(it + 1, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qb = Qs + b * BQ * kLd;
    const T* ob = Os + b * BQ * kLd;
    const float* lb = Ls + b * BQ;
    const float* db = Ds + b * BQ;

    // S^T = K_w . qs^T, then P^T (padded q columns: lse2 = +inf, P = 0)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kBf16)
      mma16_abt<D / 16, NT>(s, kw, kLd, qb, kLd);
    else
      mma32_abt<D / 8, NT>(s, kw, kLd, qb, kLd);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float l0 = lb[8 * j + 2 * t], l1 = lb[8 * j + 2 * t + 1];
      s[j][0] = prob<T>(s[j][0], l0);
      s[j][1] = prob<T>(s[j][1], l1);
      s[j][2] = prob<T>(s[j][2], l0);
      s[j][3] = prob<T>(s[j][3], l1);
    }
    // dP^T = V_w . dO^T
    float dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    if constexpr (kBf16)
      mma16_abt<D / 16, NT>(dp, vw, kLd, ob, kLd);
    else
      mma32_abt<D / 8, NT>(dp, vw, kLd, ob, kLd);
    // dV += rnd(P^T) . dO, then dS^T = P^T (dP^T - delta) in dp
    if constexpr (kBf16) {
      uint32_t pa[NT / 2][4];
      to_a16<NT>(pa, s);
      mma16_ab<NT / 2, D / 8>(dva, pa, ob, kLd);
    } else {
      add_xb_fresh<NT, D / 8>(dva, s, ob, kLd);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float d0 = db[8 * j + 2 * t], d1 = db[8 * j + 2 * t + 1];
      dp[j][0] = s[j][0] * (dp[j][0] - d0);
      dp[j][1] = s[j][1] * (dp[j][1] - d1);
      dp[j][2] = s[j][2] * (dp[j][2] - d0);
      dp[j][3] = s[j][3] * (dp[j][3] - d1);
    }
    // dK += rnd(dS^T) . qs
    if constexpr (kBf16) {
      uint32_t da[NT / 2][4];
      to_a16<NT>(da, dp);
      mma16_ab<NT / 2, D / 8>(dka, da, qb, kLd);
    } else {
      add_xb_fresh<NT, D / 8>(dka, dp, qb, kLd);
    }
    __syncthreads();  // buffer b is refilled next
  }
  cp_async_wait<0>();

  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;
  if (part == nullptr) {
    T* kb = dk + (size_t)bh * lk * D;
    T* vb = dv + (size_t)bh * lk * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (key0 < lk) {
        kb[(size_t)key0 * D + col] = from_f<T>(dka[i][0]);
        kb[(size_t)key0 * D + col + 1] = from_f<T>(dka[i][1]);
        vb[(size_t)key0 * D + col] = from_f<T>(dva[i][0]);
        vb[(size_t)key0 * D + col + 1] = from_f<T>(dva[i][1]);
      }
      if (key1 < lk) {
        kb[(size_t)key1 * D + col] = from_f<T>(dka[i][2]);
        kb[(size_t)key1 * D + col + 1] = from_f<T>(dka[i][3]);
        vb[(size_t)key1 * D + col] = from_f<T>(dva[i][2]);
        vb[(size_t)key1 * D + col + 1] = from_f<T>(dva[i][3]);
      }
    }
  } else {
    const size_t slice = (size_t)n * lk * D;  // one split's [n, lk, D]
    float* kb = part + ((size_t)z * n + bh) * lk * D;
    float* vb = kb + (size_t)gridDim.z * slice;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (key0 < lk) {
        *reinterpret_cast<float2*>(kb + (size_t)key0 * D + col) = make_float2(dka[i][0], dka[i][1]);
        *reinterpret_cast<float2*>(vb + (size_t)key0 * D + col) = make_float2(dva[i][0], dva[i][1]);
      }
      if (key1 < lk) {
        *reinterpret_cast<float2*>(kb + (size_t)key1 * D + col) = make_float2(dka[i][2], dka[i][3]);
        *reinterpret_cast<float2*>(vb + (size_t)key1 * D + col) = make_float2(dva[i][2], dva[i][3]);
      }
    }
  }
}

// dk, dv = the splits' partial sums added in split order, rounded once.
template <typename T>
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
                  size_t slice, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < slice;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int z = 0; z < splits; ++z) {
      a += part[z * slice + i];
      b += part[(splits + z) * slice + i];
    }
    dk[i] = from_f<T>(a);
    dv[i] = from_f<T>(b);
  }
}

template <typename T, int D, int BK>
struct QCfg {
  static constexpr int kLd = D + Traits<T>::kRowPad;
  static constexpr size_t kSmem = sizeof(T) * (size_t)(2 * kRowsPerCta * kLd + 4 * BK * kLd);
};

// dQ pass: grid (ceil(lq / 64), n).
template <typename T, int D, int BK>
__global__ void __launch_bounds__(128)
    dq_kernel(const T* __restrict__ qs, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse2,
              const float* __restrict__ delta, T* __restrict__ dq, int lq, int lk, int lq_pad,
              float scale) {
  using C = QCfg<T, D, BK>;
  constexpr int kLd = C::kLd;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem_bwd[];
  T* Qs = reinterpret_cast<T*>(smem_bwd);
  T* Os = Qs + kRowsPerCta * kLd;
  T* Ks = Os + kRowsPerCta * kLd;  // [2][BK][kLd]
  T* Vs = Ks + 2 * BK * kLd;       // [2][BK][kLd]

  const int bh = blockIdx.y, q0 = blockIdx.x * kRowsPerCta;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4, g = lane / 4;
  const int nkt = (lk + BK - 1) / BK;
  qs += (size_t)bh * lq * D;
  dout += (size_t)bh * lq * D;
  k += (size_t)bh * lk * D;
  v += (size_t)bh * lk * D;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;  // < lq_pad: lq_pad is a multiple of 64
  const float l0 = lse2[(size_t)bh * lq_pad + r0], l1 = lse2[(size_t)bh * lq_pad + r1];
  const float e0 = delta[(size_t)bh * lq_pad + r0], e1 = delta[(size_t)bh * lq_pad + r1];

  async_rows<T, D>(Qs, qs, kRowsPerCta, q0, lq);
  async_rows<T, D>(Os, dout, kRowsPerCta, q0, lq);
  auto load = [&](int j, int b) {
    async_rows<T, D>(Ks + b * BK * kLd, k, BK, j * BK, lk);
    async_rows<T, D>(Vs + b * BK * kLd, v, BK, j * BK, lk);
  };
  load(0, 0);
  cp_async_commit();

  constexpr int NT = BK / 8;  // key columns of S, in 8-column tiles
  float dqa[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
  const T* qw = Qs + 16 * warp * kLd;
  const T* ow = Os + 16 * warp * kLd;

  for (int j = 0; j < nkt; ++j) {
    const int b = j & 1;
    if (j + 1 < nkt) {
      load(j + 1, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = Ks + b * BK * kLd;
    const T* vb = Vs + b * BK * kLd;

    // S = qs_w . K^T, then P (padded key columns: P = 0)
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    if constexpr (kBf16)
      mma16_abt<D / 16, NT>(s, qw, kLd, kb, kLd);
    else
      mma32_abt<D / 8, NT>(s, qw, kLd, kb, kLd);
    const bool ragged = (j + 1) * BK > lk;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int col = j * BK + 8 * i + 2 * t;
      s[i][0] = prob<T>(s[i][0], l0);
      s[i][1] = prob<T>(s[i][1], l0);
      s[i][2] = prob<T>(s[i][2], l1);
      s[i][3] = prob<T>(s[i][3], l1);
      if (ragged) {
        if (col >= lk) s[i][0] = s[i][2] = 0.f;
        if (col + 1 >= lk) s[i][1] = s[i][3] = 0.f;
      }
    }
    // dP = dO_w . V^T, dS = P (dP - delta) in dp
    float dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    if constexpr (kBf16)
      mma16_abt<D / 16, NT>(dp, ow, kLd, vb, kLd);
    else
      mma32_abt<D / 8, NT>(dp, ow, kLd, vb, kLd);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      dp[i][0] = s[i][0] * (dp[i][0] - e0);
      dp[i][1] = s[i][1] * (dp[i][1] - e0);
      dp[i][2] = s[i][2] * (dp[i][2] - e1);
      dp[i][3] = s[i][3] * (dp[i][3] - e1);
    }
    // dQ += rnd(dS) . K
    if constexpr (kBf16) {
      uint32_t da[NT / 2][4];
      to_a16<NT>(da, dp);
      mma16_ab<NT / 2, D / 8>(dqa, da, kb, kLd);
    } else {
      add_xb_fresh<NT, D / 8>(dqa, dp, kb, kLd);
    }
    __syncthreads();
  }

  T* qb = dq + (size_t)bh * lq * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (r0 < lq) {
      qb[(size_t)r0 * D + col] = from_f<T>(scale * dqa[i][0]);
      qb[(size_t)r0 * D + col + 1] = from_f<T>(scale * dqa[i][1]);
    }
    if (r1 < lq) {
      qb[(size_t)r1 * D + col] = from_f<T>(scale * dqa[i][2]);
      qb[(size_t)r1 * D + col + 1] = from_f<T>(scale * dqa[i][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void* qs;
  float *delta, *lse2, *part;
  void *dq, *dk, *dv;
  int n, lq, lk, lq_pad, splits;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t smem_attr(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The q rows per step of the dK/dV pass and the keys per step of the dQ
// pass: what the registers hold (a warp's dK and dV accumulators take
// D / 2 fp32 registers a thread each).
template <typename T, int D>
struct Tiles {
  static constexpr int kBq = (sizeof(T) == 2 && D == 64) ? 64 : 32;
  static constexpr int kBk = 64;
};

template <typename T, int D>
cudaError_t run(const BwdArgs& a, int bq) {
  using TL = Tiles<T, D>;
  using KC = KvCfg<T, D, TL::kBq>;
  using QC = QCfg<T, D, TL::kBk>;
  if (bq != TL::kBq || a.lq_pad % kPad != 0 || a.lq_pad < a.lq || a.splits < 1)
    return cudaErrorInvalidValue;
  if (a.splits > 1 && a.part == nullptr) return cudaErrorInvalidValue;
  static const cudaError_t attr_kv = smem_attr(dkdv_kernel<T, D, TL::kBq>, KC::kSmem);
  static const cudaError_t attr_q = smem_attr(dq_kernel<T, D, TL::kBk>, QC::kSmem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;

  prep_kernel<T, D><<<dim3(a.lq_pad / 8, a.n), 256, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
      static_cast<T*>(a.qs), a.delta, a.lse2, a.lq, a.lq_pad, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int nqt = (a.lq + TL::kBq - 1) / TL::kBq;
  const int per = (nqt + a.splits - 1) / a.splits;
  const dim3 gkv((a.lk + kKeysPerCta - 1) / kKeysPerCta, a.n, a.splits);
  dkdv_kernel<T, D, TL::kBq><<<gkv, 128, KC::kSmem, a.stream>>>(
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), static_cast<const T*>(a.qs),
      static_cast<const T*>(a.dout), a.lse2, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.splits > 1 ? a.part : nullptr, a.n, a.lq, a.lk, a.lq_pad, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.splits > 1) {
    const size_t slice = (size_t)a.n * a.lk * D;
    const size_t want = (slice + 255) / 256;
    const int blocks = want < 132 * 8 ? (int)want : 132 * 8;
    reduce_kernel<T><<<blocks, 256, 0, a.stream>>>(a.part, static_cast<T*>(a.dk),
                                                   static_cast<T*>(a.dv), slice, a.splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const dim3 gq((a.lq + kRowsPerCta - 1) / kRowsPerCta, a.n);
  dq_kernel<T, D, TL::kBk><<<gq, 128, QC::kSmem, a.stream>>>(
      static_cast<const T*>(a.qs), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse2, a.delta, static_cast<T*>(a.dq), a.lq, a.lk, a.lq_pad,
      a.scale);
  return cudaGetLastError();
}

}  // namespace fbwd
}  // namespace

// q, o, dout, qs, dq [n, lq, d]; k, v, dk, dv [n, lk, d], all contiguous on
// the device in one dtype (0 = bf16, 1 = fp32), 16-byte aligned; lse [n, lq]
// fp32 (the kLse forward's); delta and lse2 fp32 scratch [n, lq_pad] with
// lq_pad a multiple of 64 >= lq; qs scratch in the dtype; part fp32 scratch
// [2, splits, n, lk, d] when splits > 1 (else NULL). bq is the dK/dV pass's
// q rows a step, which must be the compiled one (ops/flash_attention.py
// `backward_config`). Launches the pre-pass, the dK/dV pass (and, with
// splits > 1, the ordered reduction) and the dQ pass on `stream`; returns
// the first cudaError_t (0 on success). Allocates nothing.
extern "C" int hy3d_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                        const void* dout, const float* lse, void* qs, float* delta,
                                        float* lse2, float* part, void* dq, void* dk, void* dv,
                                        int n, int lq, int lk, int lq_pad, int d, int dtype,
                                        float scale, int bq, int splits, void* stream) {
  const fbwd::BwdArgs a{q,  k,  v,  o,  dout, lse, qs,     delta, lse2,  part,
                        dq, dk, dv, n,  lq,   lk,  lq_pad, splits, scale,
                        static_cast<cudaStream_t>(stream)};
  if (n <= 0 || lq <= 0 || lk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d == 64) return (int)fbwd::run<__nv_bfloat16, 64>(a, bq);
    if (d == 128) return (int)fbwd::run<__nv_bfloat16, 128>(a, bq);
  } else if (dtype == 1) {
    if (d == 64) return (int)fbwd::run<float, 64>(a, bq);
    if (d == 128) return (int)fbwd::run<float, 128>(a, bq);
  }
  return (int)cudaErrorInvalidValue;
}
