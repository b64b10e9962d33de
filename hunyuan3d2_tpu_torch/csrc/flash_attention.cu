// Non-causal flash attention for Hopper (sm_90a), bf16 and fp32, without
// or with a boolean mask.
//
// Replaces the Pallas TPU kernels hunyuan3d2_tpu/ops/flash_attention.py
// `flash_attention` -> `_flash` -> `_kernel` (the pallas_call at :221) and
// `flash_attention_masked` -> `_flash_masked` -> `_kernel_masked` (the
// pallas_call at :159, body :90-134). The tile-configuration sweep that
// replaces scripts/profile_flash_variants.py is flash_variants.cu, built
// from the same templates (flash_attention.cuh).
// Same function: the scale is folded into q in fp32 and rounded back to the
// input dtype before the product; softmax state (running max, normaliser)
// and the accumulator are fp32; p is rounded to the input dtype before the
// P.V product; key columns past Lk are masked to -1e30; the output is
// acc / max(l, 1e-30) in the input dtype. The masked form takes a
// [B, Lq, Lk] uint8 mask shared across the H heads; where it is 0 the score
// is -1e30 AND p is 0 (the TPU kernel's :118-123), so a fully masked row
// ends with l = 0 and an output of 0.
//
// What bounds it on the H100: 4 Lq Lk D operations against 2 (Lq + Lk) D
// elements moved, so every product-path shape is compute-bound (989 TFLOP/s
// of bf16 wgmma). At D = 64 the exponentials are a second floor: one ex2
// per score on the SFUs, 16 per clock per SM, about 4.2e12 per second on
// 132 SMs, against 256 bf16 operations per score at 989 TFLOP/s (3.9e12
// scores per second): the softmax of one tile must overlap the products of
// another, or the two floors add.
//
// Design, bf16 (D in {64, 128}; flash_attention.cuh `flash_bf16_kernel`):
//  * one CTA per (batch*head, BQ-row q tile); warpgroup 0 is the producer,
//    warpgroups 1..BQ/64 the consumers, 64 q rows each; setmaxnreg moves
//    the producer's registers to the consumers;
//  * one producer thread loads the q tile once and the K/V tiles through a
//    ring of STAGES buffers by TMA (3-D tensor maps, 128-byte swizzle, zero
//    fill past Lq and Lk); `full`/`empty` mbarriers hand each stage over;
//  * each consumer warpgroup scales its q rows in place (fp32 product
//    rounded to bf16, then fence.proxy.async), so q needs no pre-pass;
//  * S = Q.K^T on wgmma with both operands in shared memory; the online
//    softmax in registers with exp2 and log2(e) folded into one FFMA; P is
//    packed to bf16 in registers and O += P.V runs on wgmma with P as the
//    register A operand and V as the MN-major B operand;
//  * intra-warpgroup overlap: the products of tile i (S) and tile i-1 (P.V)
//    are issued together and the softmax of tile i runs while P.V is in
//    flight; with two consumers their issue turns alternate on named
//    barriers (ping-pong), so one's exponentials overlap the other's wgmma;
//  * ragged edges: padded key columns of the last tile are set to -1e30
//    (zero keys would give s = 0), rows past Lq are not stored.
// Masked (BK = 128): the producer also stages the [BQ, 128] mask tile (by
// TMA where Lk % 16 == 0, else by byte loads swizzled as TMA would), and
// walks only the key tiles that the caller's occupancy map marks as holding
// an allowed pair. Skipping an empty tile is exact: all its scores are
// -1e30, so the running max, alpha = 1, and p = 0 leave m, l and acc as
// computing it would.
//
// Design, fp32 unmasked (the VAE's self-attention, the dense fp32 decode,
// the differentiable surface; flash_attention.cuh `flash_f32_kernel`),
// D in {64, 128}: 3xTF32 split products (big.big + big.small + small.big),
// which keep fp32-grade error where plain TF32 would lose ~3 decimal
// digits, on wgmma at the TF32 tensor cores' 495 TFLOP/s (165 TFLOP/s of
// fp32-grade products, three a pair):
//  * TF32 wgmma takes only K-major operands, so a pre-pass (split_kernel)
//    writes K's split [2, n, lk, D] and V^T's [2, n, D, lk_pad] (keys
//    contiguous, permuted within each 8 so that the score accumulator is
//    the tf32 A fragment of P as it stands), 24 B H Lk D bytes a call;
//  * one CTA per (batch*head, BQ-row q tile), one producer warp keeping a
//    ring of slots full by TMA (128-byte swizzle, 32 fp32 a row), each slot
//    one split operand of one key tile: K_j, then V_j^T; 64-row consumer
//    warpgroups (BQ = 128: two; BQ = 64 where 128-row tiles would leave SMs
//    idle; D = 128: BQ = 64) split their q rows in place in shared memory;
//  * S = qs K^T with both operands in shared memory, P's big and small as A
//    fragments in registers; each key tile's P.V is summed in fresh
//    accumulators (64 output columns at a time) and added to the running
//    sum by an FMA: a tensor-core accumulator may truncate, and one carried
//    across every tile would err in proportion to Lk. The error bound of
//    this arithmetic: hunyuan3d2_tpu_torch/tools/flash_fp32_error.py.
// fp32 masked (kernel 2 under an fp32 paint stack: the turbo multiview
// attention): the same kernel's kMask instance, with the bf16 masked
// kernel's mask handling: warp 0 lists the occupied key tiles before the
// roles split and the producer walks only those; each K_j slot carries the
// [BQ, 64] mask tile (TMA with 64-byte swizzle where Lk % 16 == 0, else
// byte loads); each score's mask bit sets it to -1e30 and its p to 0. The
// pre-pass splits every key, visited or not. Tiles: (128, 64, 4 slots) at
// D = 64, (64, 64, 2) at D = 128; the producer keeps 40 registers (its byte
// loads), the consumers 232 (two) or 248 (one).
//
// Under a gradient the wrapper launches the unmasked kernel's kLse instance
// (hy3d_flash_attention_lse): the same kernel, which also writes each row's
// log-sum-exp m + log(l) in fp32; the backward (flash_attention_bwd.cu)
// recomputes the probabilities from it. Inference launches the instances
// without it.
#include "flash_attention.cuh"

namespace {

using flash::Args;

// The (BQ, BK, STAGES) configurations that flash_attention (the wrapper's
// default, a function of the shape) may launch.
#define FLASH_DEFAULTS(X, D) \
  X(D, 128, 128, 3)          \
  X(D, 64, 128, 3)

#define FLASH_TRY(D_, BQ_, BK_, ST_) \
  if (d == D_ && bq == BQ_ && bk == BK_ && stages == ST_) return flash::launch_bf16<D_, BQ_, BK_, ST_, false>(a);
#define FLASH_TRY_LSE(D_, BQ_, BK_, ST_) \
  if (d == D_ && bq == BQ_ && bk == BK_ && stages == ST_) return flash::launch_bf16<D_, BQ_, BK_, ST_, false, true>(a);

// The fp32 kernel's (BQ, BK, SLOTS) per head size: unmasked, and masked
// (one configuration a head size; K_j and its mask tile take the even slots).
#define FLASH_F32(X)  \
  X(64, 128, 64, 4)   \
  X(64, 64, 64, 6)    \
  X(128, 64, 64, 2)
#define FLASH_F32_MASKED(X) \
  X(64, 128, 64, 4)         \
  X(128, 64, 64, 2)

#define FLASH_TRY_F32(D_, BQ_, BK_, SL_) \
  if (d == D_ && bq == BQ_ && bk == BK_ && stages == SL_) return flash::launch_f32<D_, BQ_, BK_, SL_>(a);
#define FLASH_TRY_F32_LSE(D_, BQ_, BK_, SL_) \
  if (d == D_ && bq == BQ_ && bk == BK_ && stages == SL_) return flash::launch_f32<D_, BQ_, BK_, SL_, true>(a);
#define FLASH_TRY_F32_MASKED(D_, BQ_, BK_, SL_) \
  if (d == D_ && bq == BQ_ && bk == BK_ && stages == SL_) return flash::launch_f32<D_, BQ_, BK_, SL_, false, true>(a);

cudaError_t dispatch(const Args& a, int d, int dtype, int bq, int bk, int stages) {
  if (dtype == 1 && a.mask) {
    FLASH_F32_MASKED(FLASH_TRY_F32_MASKED)
    return cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    FLASH_F32(FLASH_TRY_F32)
    return cudaErrorInvalidValue;
  }
  if (a.mask) {  // three stages of K, V and mask fit at D = 64, two at D = 128
    if (bq != 128 || bk != 128) return cudaErrorInvalidValue;
    if (d == 64 && stages == 3) return flash::launch_bf16<64, 128, 128, 3, true>(a);
    if (d == 128 && stages == 2) return flash::launch_bf16<128, 128, 128, 2, true>(a);
    return cudaErrorInvalidValue;
  }
  FLASH_DEFAULTS(FLASH_TRY, 64)
  FLASH_DEFAULTS(FLASH_TRY, 128)
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_lse(const Args& a, int d, int dtype, int bq, int bk, int stages) {
  if (dtype == 1) {
    FLASH_F32(FLASH_TRY_F32_LSE)
    return cudaErrorInvalidValue;
  }
  FLASH_DEFAULTS(FLASH_TRY_LSE, 64)
  FLASH_DEFAULTS(FLASH_TRY_LSE, 128)
  return cudaErrorInvalidValue;
}

}  // namespace

// q [n, lq, d], k/v [n, lk, d], o [n, lq, d], all contiguous on the device
// (16-byte aligned), n = B * heads. mask is NULL (unmasked) or a contiguous
// [B, lq, lk] uint8 array (nonzero = attend) shared across the heads, with
// tile_map its [B, ceil(lq / bq), ceil(lk / bk)] uint8 occupancy (nonzero =
// the tile holds an allowed pair). dtype 0 = bf16, 1 = fp32; d in {64, 128};
// (bq, bk, stages) one of the compiled configurations (the fp32 kernel's
// `stages` are its ring's slots). scratch: for fp32, masked or not, fp32
// [2 n lk d + 2 n d lk_pad] with lk_pad = lk rounded up to a multiple of 64
// (the split K and V^T that its pre-pass writes), else NULL. Returns the
// cudaError_t of the launch (0 on success); the launches are asynchronous on
// `stream` and allocate nothing.
extern "C" int hy3d_flash_attention(const void* q, const void* k, const void* v, const void* mask,
                                    const void* tile_map, void* o, float* scratch, int n, int heads,
                                    int lq, int lk, int d, int dtype, float scale, int bq, int bk,
                                    int stages, void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(tile_map),
               o, n, heads, lq, lk, scale, static_cast<cudaStream_t>(stream), nullptr, scratch};
  if (!flash::valid_args(a) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(a, d, dtype, bq, bk, stages);
}

// The unmasked kernel that also writes lse [n, lq] fp32 (each row's
// log-sum-exp of its scaled logits, natural units); the other arguments as
// hy3d_flash_attention's.
extern "C" int hy3d_flash_attention_lse(const void* q, const void* k, const void* v, void* o,
                                        float* lse, float* scratch, int n, int lq, int lk, int d,
                                        int dtype, float scale, int bq, int bk, int stages,
                                        void* stream) {
  const Args a{q, k, v, nullptr, nullptr, o, n, 1, lq, lk, scale,
               static_cast<cudaStream_t>(stream), lse, scratch};
  if (!flash::valid_args(a) || lse == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_lse(a, d, dtype, bq, bk, stages);
}

// The fp32 kernels' operand pre-pass on its own (they launch it
// inside their entry points; ops/flash_attention.py `split_operand` serves
// the tests): x [n, rows, d] fp32 times `scale` -> direct [2, n, rows, d]
// (big, then small) and, unless trans is NULL, trans [2, n, d, cols] (the
// same of x^T, columns in perm8 order, zeros past rows; cols a multiple of
// 8 at least rows). d in {64, 128}. Returns the cudaError_t of the launch.
extern "C" int hy3d_split_operand(const float* x, float* direct, float* trans, int n, int rows,
                                  int cols, int d, float scale, void* stream) {
  if (n <= 0 || rows <= 0 || (d != 64 && d != 128) || direct == nullptr ||
      (trans != nullptr && (cols % 8 != 0 || cols < rows)))
    return (int)cudaErrorInvalidValue;
  return (int)flash::split_operand(x, direct, trans, n, rows, cols, d, scale,
                                   static_cast<cudaStream_t>(stream));
}
