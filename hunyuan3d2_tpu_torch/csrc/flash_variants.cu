// The tile-configuration sweep of the bf16 flash-attention kernel: every
// (BQ, BK, STAGES) that hunyuan3d2_tpu_torch/tools/profile_flash_variants.py
// times, instantiated from the templates in flash_attention.cuh.
//
// Replaces the Pallas TPU kernel scripts/profile_flash_variants.py `flash_v`
// -> `make_kernel` (the pallas_call at :72), an A/B sweep of the flash
// kernel's block sizes at the paint UNet's multiview shape. Its block sizes
// became the product kernel's defaults; here the sweep's result picks the
// default configuration of ops/flash_attention.py. A separate library, so
// that the product kernels' build does not wait for these instantiations.
//
// The set fits the 227 KB of shared memory at D = 64 and D = 128 (the
// largest, (128, 128, 3) at D = 128, takes 32 KB of q and 3 x 64 KB of K/V)
// and the register file: BQ = 128 runs two consumer warpgroups of 240
// registers, BQ = 64 one of 232 with two CTAs per SM.
#include "flash_attention.cuh"

#define FLASH_VARIANTS(X, D) \
  X(D, 64, 128, 2)           \
  X(D, 64, 128, 3)           \
  X(D, 128, 64, 3)           \
  X(D, 128, 128, 2)          \
  X(D, 128, 128, 3)

#define FLASH_TRY(D_, BQ_, BK_, ST_) \
  if (d == D_ && bq == BQ_ && bk == BK_ && stages == ST_) return (int)flash::launch_bf16<D_, BQ_, BK_, ST_, false>(a);

// bf16 q [n, lq, d], k/v [n, lk, d], o [n, lq, d], contiguous on the device;
// unmasked. Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// a configuration that is not compiled); asynchronous on `stream`.
extern "C" int hy3d_flash_variant(const void* q, const void* k, const void* v, void* o, int n,
                                  int lq, int lk, int d, float scale, int bq, int bk, int stages,
                                  void* stream) {
  const flash::Args a{q, k, v, nullptr, nullptr, o, n, 1, lq, lk, scale,
                      static_cast<cudaStream_t>(stream)};
  if (!flash::valid_args(a)) return (int)cudaErrorInvalidValue;
  FLASH_VARIANTS(FLASH_TRY, 64)
  FLASH_VARIANTS(FLASH_TRY, 128)
  return (int)cudaErrorInvalidValue;
}
