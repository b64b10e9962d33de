// The backward of kernel 1 (flash_attention_bwd.cuh) at the tiles the port
// launches: bf16 D = 64 and D = 128, each pass's fastest in
// tools/profile_flash_bwd_variants.py's sweep at the DiT training row
// [2,16,1882,64] and at [1,8,4096,128] (PERF.md), and the fp32 kernels'
// fixed tiles. ops/flash_attention.py `backward_config` sizes the scratch and
// the splits from the dK/dV pass's keys a CTA and q rows a step, both 64
// here, and pads the statistics to 128 rows (bf16: the dQ pass's 128 q rows
// a CTA) or 64 (fp32); the entry refuses sizes that do not suit its tiles.
#include "flash_attention_bwd.cuh"

// q, o, dout, qs, dq [n, lq, d]; k, v, dk, dv [n, lk, d], all contiguous on
// the device in one dtype (0 = bf16, 1 = fp32), 16-byte aligned; lse [n, lq]
// fp32 (the kLse forward's); delta and lse2 fp32 scratch [n, lq_pad] with
// lq_pad >= lq a multiple of 128 (bf16) or 64 (fp32); qs scratch in the
// dtype; part fp32 scratch [2, splits, n, lk, d] when splits > 1 (else NULL),
// splits at most the dK/dV pass's q tiles of 64 (bf16) or 32 (fp32) rows.
// Launches the pre-pass, the dK/dV pass (and, with splits > 1, the ordered
// reduction) and the dQ pass on `stream`; returns the first cudaError_t (0 on
// success). Allocates nothing.
extern "C" int hy3d_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                        const void* dout, const float* lse, void* qs, float* delta,
                                        float* lse2, float* part, void* dq, void* dk, void* dv,
                                        int n, int lq, int lk, int lq_pad, int d, int dtype,
                                        float scale, int splits, void* stream) {
  const fbwd::BwdArgs a{q,  k,  v,  o,  dout, lse, qs,     delta, lse2,  part,
                        dq, dk, dv, n,  lq,   lk,  lq_pad, splits, scale,
                        static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    // <D, dK/dV: keys a CTA, q rows a step, stages; dQ: q rows a CTA, keys a
    // step, stages>
    if (d == 64) return (int)fbwd::run_bf16<64, 64, 64, 3, 128, 128, 3>(a);
    if (d == 128) return (int)fbwd::run_bf16<128, 64, 64, 2, 128, 64, 3>(a);
  } else if (dtype == 1) {
    if (d == 64) return (int)fbwd::run_f32<64>(a);
    if (d == 128) return (int)fbwd::run_f32<128>(a);
  }
  return (int)cudaErrorInvalidValue;
}
