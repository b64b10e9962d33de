// The backward of kernel 1 (non-causal flash attention, unmasked) for Hopper
// (sm_90a), bf16 and fp32, D in {64, 128}: its kernels and their launches,
// instantiated by flash_attention_bwd.cu (the port's) and
// flash_bwd_variants.cu (the tile sweep's).
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
//    lse * log2(e), the last two padded to a multiple of the passes' q tiles
//    (`pad`; padded rows: delta 0, lse +inf, so their P is exactly 0);
//  * the dK/dV pass: a CTA owns a range of keys (K and V resident) and walks
//    the q tiles (qs, dO, lse2, delta): S^T = K qs^T, P^T, dV += rnd(P^T) dO,
//    dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += rnd(dS^T) qs; the
//    accumulators become the next product's A operand in registers. Where
//    the key ranges would leave SMs idle (the decode chunk: 16 x 8 = 128
//    CTAs walking 2,048 q tiles each), the q range is split over `splits`
//    CTAs per key range that write fp32 partial sums; a second kernel adds
//    them in split order and rounds once;
//  * the dQ pass: a CTA owns a range of q rows (qs and dO resident) and walks
//    the key tiles of K and V: S = qs K^T, P (padded keys 0), dP = dO V^T,
//    dS, dQ += rnd(dS) K; dq = scale * dQ, rounded once;
//  * bf16 (both passes, one template): warp-specialised CTAs. One producer
//    warp loads the owned rows once and keeps a ring of streamed tiles full
//    by TMA (3-D tensor maps, 128-byte swizzle; the dK/dV pass's lse2 and
//    delta by bulk copies on the same barrier); one or two consumer
//    warpgroups own 64 rows each and run every product on wgmma: the two
//    score products with both operands K-major in shared memory, the two
//    (dK/dV) or one (dQ) accumulating products with A from registers and the
//    streamed tile read MN-major from the same swizzled tile. Where the
//    registers hold a second score tile, a consumer issues the score
//    products of tile i with the accumulating products of tile i - 1 and
//    computes tile i's P and dS while the latter run (the forward's
//    pipeline), two such consumers of one CTA take turns to issue (the
//    forward's ping-pong), and at D = 64 the dK/dV pass keeps K and V as A
//    fragments in registers, so its score products read only the streamed
//    tiles from shared memory. flash_attention_bwd.cu instantiates the
//    tiles the port launches (one of each pass per head size, the fastest
//    of tools/profile_flash_bwd_variants.py's sweep over the tiles that
//    flash_bwd_variants.cu instantiates);
//  * fp32 (both passes, one template, bwd_f32): the same warp-specialised
//    shape with one consumer warpgroup a CTA and every product in 3xTF32
//    (big.big + big.small + small.big) on tf32 wgmma. TF32 wgmma takes
//    K-major operands only, and dV, dK and dQ read their B operand (dO, qs,
//    K) across rows, so the pre-pass also writes, each split into its big
//    and small halves, qs, dO, K and V as rows and qs^T, dO^T, K^T with
//    their columns permuted within each 8 (the score accumulators become
//    the A fragments as they stand): 8 n d (2 lq + 2 lq_pad + 2 lk +
//    lk_pad) bytes written and read again, where the mma.sync passes that
//    it replaced wrote the raw qs, 4 n lq d. The streamed operands pass through a ring of slots, one split
//    operand of one tile a slot, in the order the products read them. Each
//    q tile's (dK/dV pass) or key tile's (dQ pass) accumulating products
//    are summed in fresh accumulators, 64 output columns at a time, and
//    added to the running sums in fp32, so no tensor-core accumulator is
//    carried across tiles (its truncation would grow with the sequence;
//    flash_attention.cu's note).
#pragma once

#include "flash_attention.cuh"  // hopper.cuh, the forward's kLog2e, kMaxSmem and pack_p

namespace {
namespace fbwd {

using namespace hopper;
using bf16 = __nv_bfloat16;
using flash::kLog2e;
using flash::kMaxSmem;

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
// kQs false (fp32, whose split pre-pass writes qs's operands): delta and
// lse2 only, qs unused.
template <typename T, int D, bool kQs = true>
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
    if constexpr (kQs) qs[off + c] = from_f<T>(to_f(q[off + c]) * scale);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    delta[srow] = acc;
    lse2[srow] = lse[(size_t)bh * lq + row] * kLog2e;
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

// ---------------------------------------------------------------------------
// bf16: warp-specialised CTAs, a TMA ring, wgmma
// ---------------------------------------------------------------------------
// A CTA owns ROWS rows of two operands X, Y (64 a consumer warpgroup,
// loaded once) and streams TILE-row tiles of two others Xs, Ys through a
// STAGES-deep ring:
//   dQ pass    (kKV false): X, Y = qs, dO rows;  Xs, Ys = K, V tiles;
//   dK/dV pass (kKV true):  X, Y = K, V rows;    Xs, Ys = qs, dO tiles, with
//                           the tile's lse2 and delta.
// Per tile a consumer computes A = X_w Xs^T and B = Y_w Ys^T (S and dP, or
// S^T and dP^T), then P and dS in registers, then
//   dQ pass:    acc0 += rnd(dS) Xs                      (dQ)
//   dK/dV pass: acc0 += rnd(dS^T) Xs, acc1 += rnd(P^T) Ys (dK, dV).
template <bool kKV, int D, int ROWS, int TILE, int STAGES>
struct Bf16Cfg {
  static_assert(D == 64 || D == 128, "head size");
  static_assert(ROWS == 64 || ROWS == 128, "owned rows: one or two consumer warpgroups");
  static_assert(TILE == 64 || TILE == 128, "streamed tile");
  static constexpr int kConsumers = ROWS / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kMinBlocks = kConsumers == 1 ? 2 : 1;
  // 128 x (producer + kConsumers x consumer) <= 65536 / kMinBlocks (a
  // 32 / 240 split hung the card in the forward; these are its splits)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 1 ? 232 : 240;
  // fp32 registers a consumer thread holds for accumulators, both score
  // tiles and the A fragments: pipelined where a second score tile fits
  static constexpr int kLive = (kKV ? 2 : 1) * D / 2 + TILE + (kKV ? 2 : 1) * TILE / 4;
  static constexpr bool kPipe = kLive <= 192;
  // the dK/dV pass at D = 64 keeps K_w and V_w as A fragments in registers
  // (32 more), so its score products read only qs and dO from shared memory
  static constexpr bool kRegA = kKV && kPipe && D == 64;
  static constexpr int kOwnBytes = ROWS * D * 2;   // X or Y
  static constexpr int kTileBytes = TILE * D * 2;  // one Xs or Ys tile
  static constexpr int kVecBytes = kKV ? 4 * TILE : 0;
  static constexpr int kOffY = kOwnBytes;
  static constexpr int kOffXs = 2 * kOwnBytes;
  static constexpr int kOffYs = kOffXs + STAGES * kTileBytes;
  static constexpr int kOffL = kOffYs + STAGES * kTileBytes;
  static constexpr int kOffD = kOffL + STAGES * kVecBytes;
  static constexpr int kOffBar = kOffD + STAGES * kVecBytes;
  static constexpr int kStageBytes = 2 * kTileBytes + 2 * kVecBytes;
  static constexpr size_t kSmem = 1024 + kOffBar + 8 * (1 + 2 * STAGES);  // + alignment slack
  static_assert(kSmem <= (size_t)kMaxSmem, "shared memory");
};

// A = X_w . Xs^T and B = Y_w . Ys^T of one streamed tile, one commit group.
// Zeroing first ends the previous tile's live range (the asm reads its
// accumulators).
template <int D, int ROWS, int TILE>
__device__ __forceinline__ void issue_scores(float (&a)[TILE / 2], float (&b)[TILE / 2],
                                             const uint8_t* xw, const uint8_t* yw,
                                             const uint8_t* xs, const uint8_t* ys) {
#pragma unroll
  for (int e = 0; e < TILE / 2; ++e) a[e] = b[e] = 0.f;
  fence_regs(a);
  fence_regs(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss<TILE>(a, desc_kmajor(xw + c * ROWS * 128 + off), desc_kmajor(xs + c * TILE * 128 + off),
                   kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss<TILE>(b, desc_kmajor(yw + c * ROWS * 128 + off), desc_kmajor(ys + c * TILE * 128 + off),
                   kk > 0);
  }
  wgmma_commit();
}

// The same with X_w and Y_w as A fragments in registers (xa, ya).
template <int D, int TILE>
__device__ __forceinline__ void issue_scores_reg(float (&a)[TILE / 2], float (&b)[TILE / 2],
                                                 const uint32_t (&xa)[D / 16][4],
                                                 const uint32_t (&ya)[D / 16][4],
                                                 const uint8_t* xs, const uint8_t* ys) {
#pragma unroll
  for (int e = 0; e < TILE / 2; ++e) a[e] = b[e] = 0.f;
  fence_regs(a);
  fence_regs(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_kmajor<TILE>(a, xa[kk], desc_kmajor(xs + (kk / 4) * TILE * 128 + (kk % 4) * 32),
                          kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_kmajor<TILE>(b, ya[kk], desc_kmajor(ys + (kk / 4) * TILE * 128 + (kk % 4) * 32),
                          kk > 0);
  wgmma_commit();
}

// The A fragments of a warp's 16 rows (row, row + 8) of a 64-column-block
// swizzled tile whose blocks are `stride` bytes apart: k step kk holds
// columns 16 kk + 2 t, + 1 (a[0], a[1]) and 16 kk + 8 + 2 t, + 1 (a[2], a[3]).
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const uint8_t* tile, int stride,
                                       int row, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint8_t* r0 = tile + (kk / 4) * stride + row * 128 + 4 * t;
    const int lo = ((2 * (kk % 4)) ^ (row & 7)) << 4, hi = ((2 * (kk % 4) + 1) ^ (row & 7)) << 4;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(r0 + lo);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * 128 + lo);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + hi);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * 128 + hi);
  }
}

// acc += F . T over the TILE rows of the streamed tile T (F: bf16 A fragments).
template <int D, int TILE>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2], uint32_t (&f)[TILE / 16][4],
                                          const uint8_t* tile) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
    wgmma_rs<D>(acc, f[kk], desc_mnmajor(tile + kk * 2048, TILE * 128));
}

template <bool kKV, int D, int ROWS, int TILE, int STAGES>
__device__ __forceinline__ void bwd_bf16(const CUtensorMap& tx, const CUtensorMap& ty,
                                         const CUtensorMap& txs, const CUtensorMap& tys,
                                         const float* __restrict__ lse2,
                                         const float* __restrict__ delta, bf16* __restrict__ out0,
                                         bf16* __restrict__ out1, float* __restrict__ part, int n,
                                         int lq, int lk, int lq_pad, int per, float scale) {
  using C = Bf16Cfg<kKV, D, ROWS, TILE, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, r0 = blockIdx.x * ROWS;  // first owned row: key or q row
  const int nst = ((kKV ? lq : lk) + TILE - 1) / TILE;
  const int it0 = kKV ? blockIdx.z * per : 0;
  const int it1 = kKV ? min(nst, it0 + per) : nst;
  const int ntiles = it1 > it0 ? it1 - it0 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread loads the owned rows, then keeps the ring full ----
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp == 0 && lane == 0) {
      mbar_arrive_expect_tx(own_full, 2 * C::kOwnBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(smem + c * ROWS * 128, &tx, own_full, c * 64, r0, bh);
        tma_load_3d(smem + C::kOffY + c * ROWS * 128, &ty, own_full, c * 64, r0, bh);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES, row = (it0 + i) * TILE;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], C::kStageBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(smem + C::kOffXs + s * C::kTileBytes + c * TILE * 128, &txs, &full[s],
                      c * 64, row, bh);
          tma_load_3d(smem + C::kOffYs + s * C::kTileBytes + c * TILE * 128, &tys, &full[s],
                      c * 64, row, bh);
        }
        if constexpr (kKV) {  // lq_pad is a multiple of TILE: the vectors exist for every row of the tile
          bulk_load(smem + C::kOffL + s * C::kVecBytes, lse2 + (size_t)bh * lq_pad + row,
                    C::kVecBytes, &full[s]);
          bulk_load(smem + C::kOffD + s * C::kVecBytes, delta + (size_t)bh * lq_pad + row,
                    C::kVecBytes, &full[s]);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 owned rows each ----
    setmaxnreg_inc<C::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = lane % 4;
    const int row = cw * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and row + 8
    const uint8_t* xw = smem + cw * 64 * 128;
    const uint8_t* yw = smem + C::kOffY + cw * 64 * 128;
    // dQ pass: the statistics of this thread's two q rows (lq_pad is a
    // multiple of ROWS)
    float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
    if constexpr (!kKV) {
      const size_t srow = (size_t)bh * lq_pad + r0 + row;
      lr[0] = lse2[srow];
      lr[1] = lse2[srow + 8];
      dr[0] = delta[srow];
      dr[1] = delta[srow + 8];
    }
    float acc0[D / 2], acc1[kKV ? D / 2 : 1];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc0[e] = 0.f;
#pragma unroll
    for (int e = 0; e < (kKV ? D / 2 : 1); ++e) acc1[e] = 0.f;
    float sa[TILE / 2], sb[TILE / 2];                    // S (or S^T), dP (or dP^T)
    uint32_t fa[TILE / 16][4], fb[kKV ? TILE / 16 : 1][4];  // rnd(dS), rnd(P^T)

    auto xs_of = [&](int s) { return smem + C::kOffXs + s * C::kTileBytes; };
    auto ys_of = [&](int s) { return smem + C::kOffYs + s * C::kTileBytes; };
    uint32_t xa[C::kRegA ? D / 16 : 1][4], ya[C::kRegA ? D / 16 : 1][4];  // X_w, Y_w
    auto scores = [&](int s) {
      if constexpr (C::kRegA)
        issue_scores_reg<D, TILE>(sa, sb, xa, ya, xs_of(s), ys_of(s));
      else
        issue_scores<D, ROWS, TILE>(sa, sb, xw, yw, xs_of(s), ys_of(s));
    };
    auto accumulate = [&](int s) {
      fence_regs(acc0);
      if constexpr (kKV) fence_regs(acc1);
      wgmma_fence();
      issue_acc<D, TILE>(acc0, fa, xs_of(s));
      if constexpr (kKV) issue_acc<D, TILE>(acc1, fb, ys_of(s));
      wgmma_commit();
    };
    // after wgmma_wait<0>: the accumulators and fragments are free again
    auto settle = [&](int s) {
      fence_regs(acc0);
      flash::fence_p<TILE>(fa);
      if constexpr (kKV) {
        fence_regs(acc1);
        flash::fence_p<TILE>(fb);
      }
      flash::release(&empty[s]);
    };
    // P = exp2(S log2 e - lse2) into sa, dS = P (dP - delta) into sb
    auto probs = [&](int s, int it) {
      fence_regs(sa);
      fence_regs(sb);
      if constexpr (kKV) {  // statistics per column (q row); padded rows: lse2 +inf, P 0
        const float* lv = reinterpret_cast<const float*>(smem + C::kOffL + s * C::kVecBytes);
        const float* dv = reinterpret_cast<const float*>(smem + C::kOffD + s * C::kVecBytes);
#pragma unroll
        for (int i = 0; i < TILE / 8; ++i) {
          const float2 l = *reinterpret_cast<const float2*>(lv + 8 * i + 2 * t);
          const float2 d = *reinterpret_cast<const float2*>(dv + 8 * i + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(sa[4 * i + e], kLog2e, -((e & 1) ? l.y : l.x)));
            sa[4 * i + e] = p;
            sb[4 * i + e] = p * (sb[4 * i + e] - ((e & 1) ? d.y : d.x));
          }
        }
      } else {  // statistics per row; padded key columns: P 0
        const int col0 = it * TILE + 2 * t;
        const bool ragged = (it + 1) * TILE > lk;
#pragma unroll
        for (int i = 0; i < TILE / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = (e >> 1) & 1;
            float p = ex2(fmaf(sa[4 * i + e], kLog2e, -lr[h]));
            if (ragged && col0 + 8 * i + (e & 1) >= lk) p = 0.f;
            sb[4 * i + e] = p * (sb[4 * i + e] - dr[h]);
          }
        }
      }
    };
    auto pack = [&]() {
      flash::pack_p<TILE>(fa, sb);
      if constexpr (kKV) flash::pack_p<TILE>(fb, sa);
    };

    // ping-pong (the forward's): with two pipelined consumer warpgroups
    // their issues alternate (named barriers 1 and 2), so one's P and dS
    // overlap the other's products
    constexpr bool kPingPong = C::kConsumers == 2 && C::kPipe;
    const int my_turn = 1 + cw, other_turn = 2 - cw;

    mbar_wait(own_full, 0);
    if constexpr (C::kRegA) {
      load_a<D>(xa, smem, ROWS * 128, row, t);
      load_a<D>(ya, smem + C::kOffY, ROWS * 128, row, t);
    }
    if (ntiles > 0) {
      if (kPingPong && cw == 1) named_arrive(1, 256);
      mbar_wait(&full[0], 0);
      if (kPingPong) named_sync(my_turn, 256);
      scores(0);
      if (kPingPong && !(cw == 1 && ntiles == 1)) named_arrive(other_turn, 256);
      wgmma_wait<0>();
      probs(0, it0);
      pack();
      for (int i = 1; i < ntiles; ++i) {
        const int st = i % STAGES, prev = (i - 1) % STAGES;
        mbar_wait(&full[st], (i / STAGES) & 1);
        if constexpr (C::kPipe) {
          // tile i's scores with tile i - 1's accumulation; P and dS of tile
          // i while the latter runs
          if (kPingPong) named_sync(my_turn, 256);
          scores(st);
          accumulate(prev);
          if (kPingPong && !(cw == 1 && i == ntiles - 1)) named_arrive(other_turn, 256);
          wgmma_wait<1>();
          probs(st, it0 + i);
          wgmma_wait<0>();
          settle(prev);
        } else {
          accumulate(prev);
          wgmma_wait<0>();
          settle(prev);
          scores(st);
          wgmma_wait<0>();
          probs(st, it0 + i);
        }
        pack();
      }
      const int last = (ntiles - 1) % STAGES;
      accumulate(last);
      wgmma_wait<0>();
      settle(last);
    }

    const int r = r0 + row;  // this thread's rows r, r + 8 (keys or q rows)
    if constexpr (kKV) {
      if (part == nullptr) {
        bf16* kb = out0 + (size_t)bh * lk * D;
        bf16* vb = out1 + (size_t)bh * lk * D;
#pragma unroll
        for (int u = 0; u < D / 8; ++u) {
          const int col = 8 * u + 2 * t;
          if (r < lk) {
            *reinterpret_cast<uint32_t*>(kb + (size_t)r * D + col) =
                pack_bf16(acc0[4 * u], acc0[4 * u + 1]);
            *reinterpret_cast<uint32_t*>(vb + (size_t)r * D + col) =
                pack_bf16(acc1[4 * u], acc1[4 * u + 1]);
          }
          if (r + 8 < lk) {
            *reinterpret_cast<uint32_t*>(kb + (size_t)(r + 8) * D + col) =
                pack_bf16(acc0[4 * u + 2], acc0[4 * u + 3]);
            *reinterpret_cast<uint32_t*>(vb + (size_t)(r + 8) * D + col) =
                pack_bf16(acc1[4 * u + 2], acc1[4 * u + 3]);
          }
        }
      } else {
        const size_t slice = (size_t)n * lk * D;  // one split's [n, lk, D]
        float* kb = part + ((size_t)blockIdx.z * n + bh) * lk * D;
        float* vb = kb + (size_t)gridDim.z * slice;
#pragma unroll
        for (int u = 0; u < D / 8; ++u) {
          const int col = 8 * u + 2 * t;
          if (r < lk) {
            *reinterpret_cast<float2*>(kb + (size_t)r * D + col) =
                make_float2(acc0[4 * u], acc0[4 * u + 1]);
            *reinterpret_cast<float2*>(vb + (size_t)r * D + col) =
                make_float2(acc1[4 * u], acc1[4 * u + 1]);
          }
          if (r + 8 < lk) {
            *reinterpret_cast<float2*>(kb + (size_t)(r + 8) * D + col) =
                make_float2(acc0[4 * u + 2], acc0[4 * u + 3]);
            *reinterpret_cast<float2*>(vb + (size_t)(r + 8) * D + col) =
                make_float2(acc1[4 * u + 2], acc1[4 * u + 3]);
          }
        }
      }
    } else {
      bf16* qb = out0 + (size_t)bh * lq * D;
#pragma unroll
      for (int u = 0; u < D / 8; ++u) {
        const int col = 8 * u + 2 * t;
        if (r < lq)
          *reinterpret_cast<uint32_t*>(qb + (size_t)r * D + col) =
              pack_bf16(scale * acc0[4 * u], scale * acc0[4 * u + 1]);
        if (r + 8 < lq)
          *reinterpret_cast<uint32_t*>(qb + (size_t)(r + 8) * D + col) =
              pack_bf16(scale * acc0[4 * u + 2], scale * acc0[4 * u + 3]);
      }
    }
  }
}

// The two passes under their own names (a profiler tells them apart).
// dK/dV pass: grid (ceil(lk / KEYS), n, splits); split z walks q tiles
// [z * per, min(nqt, (z + 1) * per)); with part == nullptr (one split) it
// writes dk, dv in bf16, else fp32 partial sums part[0 or 1][z][bh][key][d].
template <int D, int KEYS, int BQ, int STAGES>
__global__ void __launch_bounds__(Bf16Cfg<true, D, KEYS, BQ, STAGES>::kThreads,
                                  Bf16Cfg<true, D, KEYS, BQ, STAGES>::kMinBlocks)
    dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse2, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part, int n,
                     int lq, int lk, int lq_pad, int per) {
  bwd_bf16<true, D, KEYS, BQ, STAGES>(tk, tv, tqs, tdo, lse2, delta, dk, dv, part, n, lq, lk,
                                      lq_pad, per, 1.f);
}

// dQ pass: grid (ceil(lq / ROWS), n).
template <int D, int ROWS, int BK, int STAGES>
__global__ void __launch_bounds__(Bf16Cfg<false, D, ROWS, BK, STAGES>::kThreads,
                                  Bf16Cfg<false, D, ROWS, BK, STAGES>::kMinBlocks)
    dq_bf16_kernel(const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse2, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int n, int lq, int lk, int lq_pad, float scale) {
  bwd_bf16<false, D, ROWS, BK, STAGES>(tqs, tdo, tk, tv, lse2, delta, dq, nullptr, nullptr, n, lq,
                                       lk, lq_pad, 0, scale);
}

// ---------------------------------------------------------------------------
// fp32: warp-specialised CTAs, a TMA ring of split operands, 3xTF32 on wgmma
// ---------------------------------------------------------------------------
// The bf16 template's passes with fp32-grade products. Every wgmma operand
// is K-major and split in two halves (big, small; split_tf32_exact) by the
// pre-pass (run_f32): row operands [2, n, rows, D] and transposed ones
// [2, n, D, rows_pad] whose columns are in perm8 order. A CTA owns ROWS rows
// (64 a consumer warpgroup; 128 only where the shared memory holds them:
// the dQ pass at D = 64) of two operands X, Y and streams TILE-row tiles of the
// others through a ring of SLOTS slots, one split operand a slot, in the
// order the products read them (the producer fills a slot as soon as its
// last reader is done):
//   dQ pass    (kKV false): X, Y = qs, dO rows; a tile's parts: K, V rows,
//                           then K^T;
//   dK/dV pass (kKV true):  X, Y = K, V rows; a tile's parts: qs, dO rows
//                           (with the tile's lse2 and delta), then dO^T,
//                           then qs^T.
// Per tile: A = X_w P0^T and B = Y_w P1^T (S and dP, or S^T and dP^T), P and
// dS in fp32 registers, then
//   dQ pass:    acc0 += dS P2^T                         (dQ)
//   dK/dV pass: acc1 += P^T P2^T, acc0 += dS^T P3^T     (dV, dK)
// each 64 output columns at a time in fresh accumulators added to the
// running sums in fp32 (no tensor-core accumulator is carried across
// tiles). The operand that the accumulating product reads becomes the tf32
// A fragments in registers (split_frags), the score accumulators' columns
// being in the transposed parts' perm8 order.
template <bool kKV, int D, int ROWS, int TILE, int SLOTS>
struct F32Cfg {
  static_assert(D == 64 || D == 128, "head size");
  static_assert(ROWS == 64 || ROWS == 128, "owned rows: one or two consumer warpgroups");
  static_assert(TILE == 32 || TILE == 64, "streamed tile: whole 32-column blocks");
  static constexpr int kParts = kKV ? 4 : 3;
  static constexpr int kConsumers = ROWS / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // one CTA an SM: 128 x (24 + 240 kConsumers) of the 65536 registers (232
  // spilled at D = 128 in the dK/dV pass)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kOwnHalf = ROWS * D * 4;   // one half of X or Y
  static constexpr int kPartHalf = TILE * D * 4;  // one half of a streamed part
  static constexpr int kVecBytes = kKV ? 8 * TILE : 0;  // lse2, then delta
  static constexpr int kOffY = 2 * kOwnHalf;
  static constexpr int kOffSlots = 4 * kOwnHalf;
  static constexpr int kOffVec = kOffSlots + SLOTS * 2 * kPartHalf;
  static constexpr int kOffBar = kOffVec + SLOTS * kVecBytes;
  static constexpr size_t kSmem = 1024 + kOffBar + 8 * (1 + 2 * SLOTS);  // + alignment slack
  static_assert(kSmem <= (size_t)kMaxSmem, "shared memory");
};

// acc += F . T^T over the TILE columns of the transposed part T (64 output
// columns at a time in fresh accumulators).
template <int D, int TILE>
__device__ __forceinline__ void add_tf32x3(float (&acc)[D / 2], float (&fresh)[32],
                                           const uint32_t (&fb)[TILE / 8][4],
                                           const uint32_t (&fs)[TILE / 8][4], const uint8_t* part,
                                           int small) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h) {
#pragma unroll
    for (int e = 0; e < 32; ++e) fresh[e] = 0.f;
    fence_regs(fresh);
    wgmma_fence();
    flash::tf32x3_rs<TILE / 8>(fresh, fb, fs, part + h * 64 * 128, D * 128, small);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(fresh);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[32 * h + e] += fresh[e];
  }
}

template <bool kKV, int D, int ROWS, int TILE, int SLOTS>
__device__ __forceinline__ void bwd_f32(const CUtensorMap& tx, const CUtensorMap& ty,
                                        const CUtensorMap& tp0, const CUtensorMap& tp1,
                                        const CUtensorMap& tp2, const CUtensorMap& tp3,
                                        const float* __restrict__ lse2,
                                        const float* __restrict__ delta, float* __restrict__ out0,
                                        float* __restrict__ out1, float* __restrict__ part, int n,
                                        int lq, int lk, int lq_pad, int per, float scale) {
  using C = F32Cfg<kKV, D, ROWS, TILE, SLOTS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + SLOTS;

  const int bh = blockIdx.y, r0 = blockIdx.x * ROWS;  // first owned row: key or q row
  const int nst = ((kKV ? lq : lk) + TILE - 1) / TILE;
  const int it0 = kKV ? blockIdx.z * per : 0;
  const int it1 = kKV ? min(nst, it0 + per) : nst;
  const int ntiles = it1 > it0 ? it1 - it0 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto slot = [&](int s) { return smem + C::kOffSlots + s * 2 * C::kPartHalf; };

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread loads the owned rows, then keeps the ring full ----
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp == 0 && lane == 0) {
      mbar_arrive_expect_tx(own_full, 4 * C::kOwnHalf);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < D / 32; ++c) {
          tma_load_3d(smem + half * C::kOwnHalf + c * ROWS * 128, &tx, own_full, c * 32, r0,
                      half * n + bh);
          tma_load_3d(smem + C::kOffY + half * C::kOwnHalf + c * ROWS * 128, &ty, own_full,
                      c * 32, r0, half * n + bh);
        }
      for (int p = 0; p < ntiles * C::kParts; ++p) {
        const int s = p % SLOTS, kind = p % C::kParts, row = (it0 + p / C::kParts) * TILE;
        const CUtensorMap* map = kind == 0 ? &tp0 : kind == 1 ? &tp1 : kind == 2 ? &tp2 : &tp3;
        const bool vec = kKV && kind == 0;
        uint8_t* dst = slot(s);
        mbar_wait(&empty[s], ((p / SLOTS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::kPartHalf + (vec ? C::kVecBytes : 0));
        for (int half = 0; half < 2; ++half) {
          if (kind < 2) {  // row operand: blocks of 32 columns, TILE rows each
            for (int c = 0; c < D / 32; ++c)
              tma_load_3d(dst + half * C::kPartHalf + c * TILE * 128, map, &full[s], c * 32, row,
                          half * n + bh);
          } else {  // transposed: blocks of 32 of the TILE columns, D rows each
            for (int c = 0; c < TILE / 32; ++c)
              tma_load_3d(dst + half * C::kPartHalf + c * D * 128, map, &full[s], row + c * 32, 0,
                          half * n + bh);
          }
        }
        if (vec) {  // lq_pad is a multiple of TILE: the vectors exist for every row of the tile
          uint8_t* v = smem + C::kOffVec + s * C::kVecBytes;
          bulk_load(v, lse2 + (size_t)bh * lq_pad + row, 4 * TILE, &full[s]);
          bulk_load(v + 4 * TILE, delta + (size_t)bh * lq_pad + row, 4 * TILE, &full[s]);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 owned rows each ----
    setmaxnreg_inc<C::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, t = lane % 4;
    const int row = cw * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and row + 8
    const uint8_t* xw = smem + cw * 64 * 128;
    const uint8_t* yw = smem + C::kOffY + cw * 64 * 128;
    // dQ pass: the statistics of this thread's two q rows (lq_pad is a
    // multiple of ROWS)
    float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
    if constexpr (!kKV) {
      const size_t srow = (size_t)bh * lq_pad + r0 + row;
      lr[0] = lse2[srow];
      lr[1] = lse2[srow + 8];
      dr[0] = delta[srow];
      dr[1] = delta[srow + 8];
    }
    float acc0[D / 2], acc1[kKV ? D / 2 : 1], fresh[32];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc0[e] = 0.f;
#pragma unroll
    for (int e = 0; e < (kKV ? D / 2 : 1); ++e) acc1[e] = 0.f;
    float sa[TILE / 2], sb[TILE / 2];  // S (or S^T), dP (or dP^T); then P, dS
    uint32_t fb[TILE / 8][4], fs[TILE / 8][4];

    auto wait_part = [&](int p) {
      mbar_wait(&full[p % SLOTS], (p / SLOTS) & 1);
      return slot(p % SLOTS);
    };
    auto free_part = [&](int p) { flash::release(&empty[p % SLOTS]); };

    mbar_wait(own_full, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int p0 = i * C::kParts;
      const uint8_t* x0 = wait_part(p0);
      const uint8_t* x1 = wait_part(p0 + 1);
#pragma unroll
      for (int e = 0; e < TILE / 2; ++e) sa[e] = sb[e] = 0.f;
      fence_regs(sa);
      fence_regs(sb);
      wgmma_fence();
      flash::tf32x3_ss<TILE, D / 8>(sa, xw, ROWS * 128, C::kOwnHalf, x0, TILE * 128, C::kPartHalf,
                                    false);
      flash::tf32x3_ss<TILE, D / 8>(sb, yw, ROWS * 128, C::kOwnHalf, x1, TILE * 128, C::kPartHalf,
                                    false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(sb);

      // P = exp2(S log2 e - lse2) into sa, dS = P (dP - delta) into sb
      if constexpr (kKV) {  // statistics per column (q row); padded rows: lse2 +inf, P 0
        const float* lv = reinterpret_cast<const float*>(smem + C::kOffVec +
                                                         (p0 % SLOTS) * C::kVecBytes);
        const float* dv = lv + TILE;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lv + 8 * j + 2 * t);
          const float2 d = *reinterpret_cast<const float2*>(dv + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(fmaf(sa[4 * j + e], kLog2e, -((e & 1) ? l.y : l.x)));
            sa[4 * j + e] = p;
            sb[4 * j + e] = p * (sb[4 * j + e] - ((e & 1) ? d.y : d.x));
          }
        }
      } else {  // statistics per row; padded key columns: P 0
        const int col0 = (it0 + i) * TILE + 2 * t;
        const bool ragged = (it0 + i + 1) * TILE > lk;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = (e >> 1) & 1;
            float p = exp2f(fmaf(sa[4 * j + e], kLog2e, -lr[h]));
            if (ragged && col0 + 8 * j + (e & 1) >= lk) p = 0.f;
            sb[4 * j + e] = p * (sb[4 * j + e] - dr[h]);
          }
        }
      }
      free_part(p0);
      free_part(p0 + 1);

      if constexpr (kKV) {
        flash::split_frags<TILE / 8>(fb, fs, sa);  // P^T
        add_tf32x3<D, TILE>(acc1, fresh, fb, fs, wait_part(p0 + 2), C::kPartHalf);  // dV
        free_part(p0 + 2);
        flash::fence_frags(fb);
        flash::fence_frags(fs);
        flash::split_frags<TILE / 8>(fb, fs, sb);  // dS^T
        add_tf32x3<D, TILE>(acc0, fresh, fb, fs, wait_part(p0 + 3), C::kPartHalf);  // dK
        free_part(p0 + 3);
      } else {
        flash::split_frags<TILE / 8>(fb, fs, sb);  // dS
        add_tf32x3<D, TILE>(acc0, fresh, fb, fs, wait_part(p0 + 2), C::kPartHalf);  // dQ
        free_part(p0 + 2);
      }
      flash::fence_frags(fb);
      flash::fence_frags(fs);
    }

    const int r = r0 + row;  // this thread's rows r, r + 8 (keys or q rows)
    if constexpr (kKV) {
      float* kb;
      float* vb;
      if (part == nullptr) {
        kb = out0 + (size_t)bh * lk * D;
        vb = out1 + (size_t)bh * lk * D;
      } else {  // this split's partial sums part[0 or 1][z][bh][key][d]
        kb = part + ((size_t)blockIdx.z * n + bh) * lk * D;
        vb = kb + (size_t)gridDim.z * n * lk * D;
      }
#pragma unroll
      for (int u = 0; u < D / 8; ++u) {
        const int col = 8 * u + 2 * t;
        if (r < lk) {
          *reinterpret_cast<float2*>(kb + (size_t)r * D + col) = make_float2(acc0[4 * u], acc0[4 * u + 1]);
          *reinterpret_cast<float2*>(vb + (size_t)r * D + col) = make_float2(acc1[4 * u], acc1[4 * u + 1]);
        }
        if (r + 8 < lk) {
          *reinterpret_cast<float2*>(kb + (size_t)(r + 8) * D + col) =
              make_float2(acc0[4 * u + 2], acc0[4 * u + 3]);
          *reinterpret_cast<float2*>(vb + (size_t)(r + 8) * D + col) =
              make_float2(acc1[4 * u + 2], acc1[4 * u + 3]);
        }
      }
    } else {
      float* qb = out0 + (size_t)bh * lq * D;
#pragma unroll
      for (int u = 0; u < D / 8; ++u) {
        const int col = 8 * u + 2 * t;
        if (r < lq)
          *reinterpret_cast<float2*>(qb + (size_t)r * D + col) =
              make_float2(scale * acc0[4 * u], scale * acc0[4 * u + 1]);
        if (r + 8 < lq)
          *reinterpret_cast<float2*>(qb + (size_t)(r + 8) * D + col) =
              make_float2(scale * acc0[4 * u + 2], scale * acc0[4 * u + 3]);
      }
    }
  }
}

// dK/dV pass: grid (ceil(lk / KEYS), n, splits); split z walks q tiles
// [z * per, min(nqt, (z + 1) * per)); with part == nullptr (one split) it
// writes dk, dv, else fp32 partial sums part[0 or 1][z][bh][key][d].
template <int D, int KEYS, int TILE, int SLOTS>
__global__ void __launch_bounds__(F32Cfg<true, D, KEYS, TILE, SLOTS>::kThreads, 1)
    dkdv_f32_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdot, const __grid_constant__ CUtensorMap tqst,
                    const float* __restrict__ lse2, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part, int n,
                    int lq, int lk, int lq_pad, int per) {
  bwd_f32<true, D, KEYS, TILE, SLOTS>(tk, tv, tqs, tdo, tdot, tqst, lse2, delta, dk, dv, part, n,
                                      lq, lk, lq_pad, per, 1.f);
}

// dQ pass: grid (ceil(lq / ROWS), n).
template <int D, int ROWS, int TILE, int SLOTS>
__global__ void __launch_bounds__(F32Cfg<false, D, ROWS, TILE, SLOTS>::kThreads, 1)
    dq_f32_kernel(const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tkt, const float* __restrict__ lse2,
                  const float* __restrict__ delta, float* __restrict__ dq, int n, int lq, int lk,
                  int lq_pad, float scale) {
  bwd_f32<false, D, ROWS, TILE, SLOTS>(tqs, tdo, tk, tv, tkt, tkt, lse2, delta, dq, nullptr,
                                       nullptr, n, lq, lk, lq_pad, 0, scale);
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

template <typename T, int D>
cudaError_t prep(const BwdArgs& a) {
  prep_kernel<T, D><<<dim3(a.lq_pad / 8, a.n), 256, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
      static_cast<T*>(a.qs), a.delta, a.lse2, a.lq, a.lq_pad, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t reduce(const BwdArgs& a) {
  const size_t slice = (size_t)a.n * a.lk * D;
  const size_t want = (slice + 255) / 256;
  const int blocks = want < 132 * 8 ? (int)want : 132 * 8;
  reduce_kernel<T><<<blocks, 256, 0, a.stream>>>(a.part, static_cast<T*>(a.dk),
                                                 static_cast<T*>(a.dv), slice, a.splits);
  return cudaGetLastError();
}

// A [n, rows, D] bf16 tensor as TMA boxes of 64 columns x `box` rows.
inline bool bf16_map(CUtensorMap* map, const void* p, int D, int rows, int n, int box) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, D, rows, n, 64, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, int KEYS, int BQ, int STAGES>
cudaError_t launch_dkdv_bf16(const BwdArgs& a) {
  using C = Bf16Cfg<true, D, KEYS, BQ, STAGES>;
  CUtensorMap tk, tv, tqs, tdo;
  if (!bf16_map(&tk, a.k, D, a.lk, a.n, KEYS) || !bf16_map(&tv, a.v, D, a.lk, a.n, KEYS) ||
      !bf16_map(&tqs, a.qs, D, a.lq, a.n, BQ) || !bf16_map(&tdo, a.dout, D, a.lq, a.n, BQ))
    return cudaErrorInvalidDevicePointer;  // the driver refused a tensor map
  static const cudaError_t attr = smem_attr(dkdv_bf16_kernel<D, KEYS, BQ, STAGES>, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const int nqt = (a.lq + BQ - 1) / BQ;
  const int per = (nqt + a.splits - 1) / a.splits;
  const dim3 grid((a.lk + KEYS - 1) / KEYS, a.n, a.splits);
  dkdv_bf16_kernel<D, KEYS, BQ, STAGES><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      tk, tv, tqs, tdo, a.lse2, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.splits > 1 ? a.part : nullptr, a.n, a.lq, a.lk, a.lq_pad, per);
  return cudaGetLastError();
}

template <int D, int ROWS, int BK, int STAGES>
cudaError_t launch_dq_bf16(const BwdArgs& a) {
  using C = Bf16Cfg<false, D, ROWS, BK, STAGES>;
  CUtensorMap tqs, tdo, tk, tv;
  if (!bf16_map(&tqs, a.qs, D, a.lq, a.n, ROWS) || !bf16_map(&tdo, a.dout, D, a.lq, a.n, ROWS) ||
      !bf16_map(&tk, a.k, D, a.lk, a.n, BK) || !bf16_map(&tv, a.v, D, a.lk, a.n, BK))
    return cudaErrorInvalidDevicePointer;
  static const cudaError_t attr = smem_attr(dq_bf16_kernel<D, ROWS, BK, STAGES>, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.lq + ROWS - 1) / ROWS, a.n);
  dq_bf16_kernel<D, ROWS, BK, STAGES><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      tqs, tdo, tk, tv, a.lse2, a.delta, static_cast<bf16*>(a.dq), a.n, a.lq, a.lk, a.lq_pad,
      a.scale);
  return cudaGetLastError();
}

// Whether a call's sizes suit the dK/dV pass's `rows` q rows a step and
// statistics padded to a multiple of `pad` rows: every split of the q range
// holds at least one q tile.
inline bool valid(const BwdArgs& a, int rows, int pad) {
  return a.n > 0 && a.lq > 0 && a.lk > 0 && a.lq_pad >= a.lq && a.lq_pad % pad == 0 &&
         a.splits >= 1 && a.splits <= (a.lq + rows - 1) / rows &&
         (a.splits == 1 || a.part != nullptr);
}

// The bf16 backward at one tile configuration: the dK/dV pass's keys a CTA,
// q rows a step and ring stages; the dQ pass's q rows a CTA, keys a step and
// ring stages. lse2 / delta must exist for every row of the dK/dV pass's
// last q tile and of the dQ pass's last CTA.
template <int D, int KV_KEYS, int KV_ROWS, int KV_STAGES, int Q_ROWS, int Q_KEYS, int Q_STAGES>
cudaError_t run_bf16(const BwdArgs& a) {
  constexpr int kPad = KV_ROWS > Q_ROWS ? KV_ROWS : Q_ROWS;
  static_assert(kPad % KV_ROWS == 0 && kPad % Q_ROWS == 0, "q tiles of 64 or 128 rows");
  if (!valid(a, KV_ROWS, kPad)) return cudaErrorInvalidValue;
  cudaError_t err = prep<bf16, D>(a);
  if (err != cudaSuccess) return err;
  if ((err = launch_dkdv_bf16<D, KV_KEYS, KV_ROWS, KV_STAGES>(a)) != cudaSuccess) return err;
  if (a.splits > 1 && (err = reduce<bf16, D>(a)) != cudaSuccess) return err;
  return launch_dq_bf16<D, Q_ROWS, Q_KEYS, Q_STAGES>(a);
}

// The fp32 scratch (BwdArgs::qs) of a call, in floats: the split operands
// that run_f32's pre-pass writes (f32_layout).
struct F32Layout {
  size_t qs, dout, qst, dot, k, v, kt, total;
  int lk_pad;
};

inline F32Layout f32_layout(const BwdArgs& a, int d) {
  F32Layout l;
  const size_t q = (size_t)2 * a.n * a.lq * d, qt = (size_t)2 * a.n * d * a.lq_pad;
  const size_t k = (size_t)2 * a.n * a.lk * d;
  l.lk_pad = flash::key_pad(a.lk);
  l.qs = 0;
  l.dout = l.qs + q;
  l.qst = l.dout + q;
  l.dot = l.qst + qt;
  l.k = l.dot + qt;
  l.v = l.k + k;
  l.kt = l.v + k;
  l.total = l.kt + (size_t)2 * a.n * d * l.lk_pad;
  return l;
}

// The fp32 backward: the pre-pass (delta, lse2; the split operands), the
// dK/dV pass (KV_KEYS keys a CTA, KV_TILE q rows a step, KV_SLOTS slots;
// with splits > 1 the ordered reduction), the dQ pass (Q_ROWS q rows a CTA,
// Q_TILE keys a step, Q_SLOTS slots). a.qs: fp32 scratch of
// f32_layout(a, D).total floats; lq_pad a multiple of Q_ROWS.
template <int D, int KV_KEYS, int KV_TILE, int KV_SLOTS, int Q_ROWS, int Q_TILE, int Q_SLOTS>
cudaError_t run_f32(const BwdArgs& a) {
  using KC = F32Cfg<true, D, KV_KEYS, KV_TILE, KV_SLOTS>;
  using QC = F32Cfg<false, D, Q_ROWS, Q_TILE, Q_SLOTS>;
  static_assert(Q_ROWS % KV_TILE == 0, "q tiles of the dK/dV pass within the padded rows");
  if (!valid(a, KV_TILE, Q_ROWS) || a.qs == nullptr) return cudaErrorInvalidValue;
  static const cudaError_t attr_kv =
      smem_attr(dkdv_f32_kernel<D, KV_KEYS, KV_TILE, KV_SLOTS>, KC::kSmem);
  static const cudaError_t attr_q = smem_attr(dq_f32_kernel<D, Q_ROWS, Q_TILE, Q_SLOTS>, QC::kSmem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const F32Layout l = f32_layout(a, D);
  float* w = static_cast<float*>(a.qs);
  CUtensorMap tqs, tdo, tqst, tdot, tk, tv, tkt, tqs_q, tdo_q, tk_q, tv_q;
  using flash::f32_map;
  if (!f32_map(&tk, w + l.k, D, a.lk, 2 * a.n, KV_KEYS) ||
      !f32_map(&tv, w + l.v, D, a.lk, 2 * a.n, KV_KEYS) ||
      !f32_map(&tqs, w + l.qs, D, a.lq, 2 * a.n, KV_TILE) ||
      !f32_map(&tdo, w + l.dout, D, a.lq, 2 * a.n, KV_TILE) ||
      !f32_map(&tqst, w + l.qst, a.lq_pad, D, 2 * a.n, D) ||
      !f32_map(&tdot, w + l.dot, a.lq_pad, D, 2 * a.n, D) ||
      !f32_map(&tqs_q, w + l.qs, D, a.lq, 2 * a.n, Q_ROWS) ||
      !f32_map(&tdo_q, w + l.dout, D, a.lq, 2 * a.n, Q_ROWS) ||
      !f32_map(&tk_q, w + l.k, D, a.lk, 2 * a.n, Q_TILE) ||
      !f32_map(&tv_q, w + l.v, D, a.lk, 2 * a.n, Q_TILE) ||
      !f32_map(&tkt, w + l.kt, l.lk_pad, D, 2 * a.n, D))
    return cudaErrorInvalidDevicePointer;  // the driver refused a tensor map

  // pre-pass: delta, lse2; then qs (q * scale), dO, K rows and transposed, V rows
  prep_kernel<float, D, false><<<dim3(a.lq_pad / 8, a.n), 256, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), a.lse, nullptr, a.delta, a.lse2, a.lq, a.lq_pad, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using flash::split_operand;
  if ((err = split_operand(static_cast<const float*>(a.q), w + l.qs, w + l.qst, a.n, a.lq,
                           a.lq_pad, D, a.scale, a.stream)) != cudaSuccess ||
      (err = split_operand(static_cast<const float*>(a.dout), w + l.dout, w + l.dot, a.n, a.lq,
                           a.lq_pad, D, 1.f, a.stream)) != cudaSuccess ||
      (err = split_operand(static_cast<const float*>(a.k), w + l.k, w + l.kt, a.n, a.lk, l.lk_pad,
                           D, 1.f, a.stream)) != cudaSuccess ||
      (err = split_operand(static_cast<const float*>(a.v), w + l.v, nullptr, a.n, a.lk, 0, D, 1.f,
                           a.stream)) != cudaSuccess)
    return err;

  const int nqt = (a.lq + KV_TILE - 1) / KV_TILE;
  const int per = (nqt + a.splits - 1) / a.splits;
  const dim3 gkv((a.lk + KV_KEYS - 1) / KV_KEYS, a.n, a.splits);
  dkdv_f32_kernel<D, KV_KEYS, KV_TILE, KV_SLOTS><<<gkv, KC::kThreads, KC::kSmem, a.stream>>>(
      tk, tv, tqs, tdo, tdot, tqst, a.lse2, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.splits > 1 ? a.part : nullptr, a.n, a.lq, a.lk, a.lq_pad, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.splits > 1 && (err = reduce<float, D>(a)) != cudaSuccess) return err;

  const dim3 gq((a.lq + Q_ROWS - 1) / Q_ROWS, a.n);
  dq_f32_kernel<D, Q_ROWS, Q_TILE, Q_SLOTS><<<gq, QC::kThreads, QC::kSmem, a.stream>>>(
      tqs_q, tdo_q, tk_q, tv_q, tkt, a.lse2, a.delta, static_cast<float*>(a.dq), a.n, a.lq, a.lk,
      a.lq_pad, a.scale);
  return cudaGetLastError();
}

}  // namespace fbwd
}  // namespace
