// The tile sweep of kernel 1's bf16 backward: every tile of its two passes
// that hunyuan3d2_tpu_torch/tools/profile_flash_bwd_variants.py times,
// instantiated from the templates in flash_attention_bwd.cuh. The sweep's
// fastest tiles of each pass are the ones flash_attention_bwd.cu launches.
// A separate library, so that the port's build does not wait for these
// instantiations.
//
// 64 keys or q rows a CTA is one consumer warpgroup (two CTAs an SM), 128
// two. Each tile fits the 227 KB of shared memory and the register file
// without a spill.
#include "flash_attention_bwd.cuh"

// (D, keys a CTA, q rows a step, stages) of the dK/dV pass
#define BWD_KV_VARIANTS(X) \
  X(64, 64, 64, 2)         \
  X(64, 64, 64, 3)         \
  X(64, 128, 64, 2)        \
  X(64, 128, 64, 3)        \
  X(64, 128, 128, 2)       \
  X(128, 64, 64, 2)        \
  X(128, 128, 64, 2)
// (D, q rows a CTA, keys a step, stages) of the dQ pass
#define BWD_Q_VARIANTS(X) \
  X(64, 64, 128, 2)       \
  X(64, 128, 64, 2)       \
  X(64, 128, 128, 2)      \
  X(64, 128, 128, 3)      \
  X(64, 128, 128, 4)      \
  X(128, 64, 64, 2)       \
  X(128, 128, 64, 2)      \
  X(128, 128, 64, 3)      \
  X(128, 128, 64, 4)

// bf16 only; the arguments as hy3d_flash_attention_bwd's (flash_attention_bwd.cu),
// with lq_pad a multiple of the larger of kv_rows and q_rows, and the six tile
// numbers of a compiled variant of each pass (else cudaErrorInvalidValue).
// Launches the pre-pass, the dK/dV pass (with its ordered reduction where
// splits > 1) and the dQ pass on `stream`.
extern "C" int hy3d_flash_bwd_variant(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* lse, void* qs, float* delta,
                                      float* lse2, float* part, void* dq, void* dk, void* dv, int n,
                                      int lq, int lk, int lq_pad, int d, float scale, int kv_keys,
                                      int kv_rows, int kv_stages, int q_rows, int q_keys,
                                      int q_stages, int splits, void* stream) {
  using namespace fbwd;
  const BwdArgs a{q,  k,  v,  o,  dout, lse, qs,     delta, lse2,  part,
                  dq, dk, dv, n,  lq,   lk,  lq_pad, splits, scale,
                  static_cast<cudaStream_t>(stream)};
  const int pad = kv_rows > q_rows ? kv_rows : q_rows;
  bool kv = false, qt = false;
#define KV_MATCH(D_, K_, R_, S_) (d == D_ && kv_keys == K_ && kv_rows == R_ && kv_stages == S_)
#define Q_MATCH(D_, R_, K_, S_) (d == D_ && q_rows == R_ && q_keys == K_ && q_stages == S_)
#define KV_SEEN(D_, K_, R_, S_) kv = kv || KV_MATCH(D_, K_, R_, S_);
#define Q_SEEN(D_, R_, K_, S_) qt = qt || Q_MATCH(D_, R_, K_, S_);
  BWD_KV_VARIANTS(KV_SEEN)
  BWD_Q_VARIANTS(Q_SEEN)
  if (!kv || !qt || !valid(a, kv_rows, pad)) return (int)cudaErrorInvalidValue;
  cudaError_t err = d == 64 ? prep<bf16, 64>(a) : prep<bf16, 128>(a);
  if (err != cudaSuccess) return (int)err;
#define KV_RUN(D_, K_, R_, S_) \
  if (KV_MATCH(D_, K_, R_, S_)) err = launch_dkdv_bf16<D_, K_, R_, S_>(a);
  BWD_KV_VARIANTS(KV_RUN)
  if (err != cudaSuccess) return (int)err;
  if (splits > 1 && (err = d == 64 ? reduce<bf16, 64>(a) : reduce<bf16, 128>(a)) != cudaSuccess)
    return (int)err;
#define Q_RUN(D_, R_, K_, S_) \
  if (Q_MATCH(D_, R_, K_, S_)) err = launch_dq_bf16<D_, R_, K_, S_>(a);
  BWD_Q_VARIANTS(Q_RUN)
  return (int)err;
}
