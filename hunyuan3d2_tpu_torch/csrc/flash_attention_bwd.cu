// The backward of kernel 1 (flash_attention_bwd.cuh) at the tiles the port
// launches: bf16 D = 64 and D = 128, each pass's fastest in
// tools/profile_flash_bwd_variants.py's sweep at the DiT training row
// [2,16,1882,64] and at [1,8,4096,128] (PERF.md), and the fp32 passes'
// tiles (what fits the 227 KB of shared memory with the split operands:
// one consumer warpgroup a CTA, but two in the dQ pass at D = 64, which
// chip_smoke's phase 12a timed faster at the decode chunk; two in the dK/dV
// pass, whose consumers then wait on each other's slots, were slower).
// ops/flash_attention.py `backward_config` sizes the scratch and the splits
// from the dK/dV pass's 64 keys a CTA and its q rows a step (bf16 64, fp32
// 32), and pads the statistics to the dQ pass's q rows a CTA (128; fp32 64
// at D = 128); the entry refuses sizes that do not suit its tiles.
#include "flash_attention_bwd.cuh"

// q, o, dout, dq [n, lq, d]; k, v, dk, dv [n, lk, d], all contiguous on the
// device in one dtype (0 = bf16, 1 = fp32), 16-byte aligned; lse [n, lq]
// fp32 (the kLse forward's); delta and lse2 fp32 scratch [n, lq_pad] with
// lq_pad >= lq a multiple of 128 (bf16, fp32 at d = 64) or 64 (fp32 at
// d = 128); qs scratch: bf16
// [n, lq, d], fp32 the split operands, 2 n d (2 lq + 2 lq_pad + 2 lk +
// lk_pad) floats with lk_pad = lk rounded up to a multiple of 64; part fp32
// scratch [2, splits, n, lk, d] when splits > 1 (else NULL), splits at most
// the dK/dV pass's q tiles of 64 (bf16) or 32 (fp32) rows.
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
    // <D, dK/dV: keys a CTA, q rows a step, slots; dQ: q rows a CTA, keys
    // a step, slots>
    if (d == 64) return (int)fbwd::run_f32<64, 64, 32, 8, 128, 64, 3>(a);
    if (d == 128) return (int)fbwd::run_f32<128, 64, 32, 3, 64, 32, 3>(a);
  }
  return (int)cudaErrorInvalidValue;
}
