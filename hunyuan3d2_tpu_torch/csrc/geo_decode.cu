// Fused ShapeVAE geo decoder for Hopper (sm_90a): xyz queries -> occupancy logits.
//
// Replaces the Pallas TPU kernel hunyuan3d2_tpu/ops/geo_decoder_pallas.py
// `fused_geo_decode` -> `_kernel` (the pallas_call at :221). Same chain, same
// dtype policy: Fourier embedding (fp32, rounded to bf16) -> query_proj ->
// LN1 -> c_q -> per-head q LayerNorm -> softmax cross-attention over the
// latent K/V (fp32 softmax, normalised probabilities rounded to bf16) ->
// c_proj + residual -> LN3 -> 4W exact-GELU MLP, taken in 64-column chunks and
// accumulated -> ln_post -> one-channel output. Every product has bf16
// inputs and an fp32 accumulator; the residual stream stays fp32 throughout,
// as in the Pallas kernel. GELU uses erff (the Pallas kernel an A&S erf with
// error <= 1.5e-7).
//
// What bounds it on the H100: about 23 MFLOP per query at the mini VAE
// (width 1024, 16 heads of 64, 512 latents, MLP 4096) against 12 bytes in and
// 4 bytes out, so the function is compute-bound by far (the card needs ~295
// operations per byte). The cost this design pays instead is weight traffic:
// every CTA streams all ~22 MB of bf16 weights and K/V from the 50 MB L2.
//
// Design (a simple, correct first version; wgmma/TMA/warp specialisation and
// larger query tiles are later work):
//  * The TPU tile keeps a [256, W] fp32 accumulator plus a [256, W] bf16
//    scratch (1.5 MB at W=1024); a Hopper block has at most 227 KB of shared
//    memory. So a CTA takes a tile of 16 queries (one mma.sync m-tile): the
//    fp32 residual [16, W] (64 KB) and one bf16 activation buffer [16, W]
//    (32 KB) live in shared memory for the whole chain, so no activation
//    touches device memory. One CTA of 8 warps per tile, one CTA per SM.
//  * Products run on the tensor cores with mma.sync.m16n8k16 (bf16 inputs,
//    fp32 accumulate). A fragments come from shared memory (rows padded by 8
//    elements: conflict-free); B fragments are read from the weights in
//    device memory (L2-resident) in their torch [out, in] layout, which is
//    the column-major B the instruction wants.
//  * Attention runs head by head: q for one head (LayerNorm over its 64
//    values), the [16, L] scores in shared memory, an exact fp32 softmax
//    (no online rescaling: L <= 1024 fits), P.V, and the head's slice of
//    c_proj is accumulated straight into the fp32 residual, so the full
//    [16, W] attention output is never stored.
//  * The MLP never stores its [16, 4W] hidden layer: each 64-column chunk is
//    computed, passed through GELU into a small bf16 tile, and multiplied
//    into the residual at once (y = sum_c gelu(h W1_c) W2_c, exact).
//
// A second kernel, `geo_mlp_kernel`, replaces the Pallas TPU kernel
// hunyuan3d2_tpu/ops/geo_decoder_pallas.py `fused_geo_decode_stream` ->
// `_geo_mlp_kernel` (the pallas_call at :377, body :274-296): the MLP tail of
// the streamed decode that takes > 1024 latents (v2-0: 3072), where the K/V
// no longer fits beside the chain and the projections and the attention run
// outside (cuBLAS and the flash kernel). Its input is x2 = x + c_proj(attn)
// rounded to bf16 [P, W]; it computes LN3 -> 4W exact-GELU MLP -> + x2 + bpj
// -> ln_post -> the one-channel output, with the fp32 residual of the Pallas
// kernel. This is kernel 3's tail from the residual on, so both kernels call
// one __device__ routine, `mlp_tail`.
//
// What bounds kernel 4 on the H100: per query 4*W*M = 16.8 MFLOP (W = 1024,
// M = 4096) against 2*W + 4 bytes of activations, so it is operations-bound
// (3.4 ms of bf16 tensor-core time at P = 200,000). Every CTA reads the 16.8
// MB of bf16 MLP weights once from the L2. A CTA takes 32 rows (two mma
// m-tiles) rather than kernel 3's 16: each B fragment read from the L2 then
// feeds two mma.sync, halving the L2 weight traffic per operation, and the
// fp32 residual [32, W] (132 KB) + bf16 LN3 output [32, W] (66 KB) + the GELU
// tile still fit the 227 KB of one block (W <= 1152). Rows past P are zero
// and never written, so a ragged P needs no padded copy of x2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The kernel's arguments; the Python wrapper mirrors this layout with ctypes.
struct GeoArgs {
  const float* pts;  // [P, 3]
  const __nv_bfloat16* wqp;   // [W, 64], zero-padded past the embedding width
  const float* bqp;  // [W]
  const float* ln1s;
  const float* ln1b;
  const __nv_bfloat16* wcq;   // [W, W]
  const float* bcq;  // [W]
  const float* qns;  // [D]
  const float* qnb;  // [D]
  const __nv_bfloat16* k;     // [H, L, D], k LayerNorm applied
  const __nv_bfloat16* v;     // [H, L, D]
  const __nv_bfloat16* wcp;   // [W, W]
  const float* bcp;
  const float* ln3s;
  const float* ln3b;
  const __nv_bfloat16* wfc;   // [M, W]
  const float* bfc;  // [M]
  const __nv_bfloat16* wpj;   // [W, M]
  const float* bpj;
  const float* lnps;
  const float* lnpb;
  const __nv_bfloat16* wout;  // [W]
  float* out;        // [P]
  int P, W, H, D, L, M, num_freqs;
  float freq_mul, eps, scale, bout;
};

// The MLP tail's arguments (kernel 4 reads x2; kernel 3 passes its own
// residual and leaves x2 null); the Python wrapper mirrors this layout.
struct MlpArgs {
  const __nv_bfloat16* x2;    // [P, W]
  const float* ln3s;
  const float* ln3b;
  const __nv_bfloat16* wfc;   // [M, W]
  const float* bfc;  // [M]
  const __nv_bfloat16* wpj;   // [W, M]
  const float* bpj;
  const float* lnps;
  const float* lnpb;
  const __nv_bfloat16* wout;  // [W]
  float* out;        // [P]
  int P, W, M;
  float eps, bout;
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 16;     // queries per CTA: one mma m-tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kEmb = 64;      // Fourier embedding width, zero-padded
constexpr int kChunk = 64;    // MLP columns per chunk
constexpr int kTileLd = 136;  // row stride of the small bf16 tile (<= 128 columns + 8)

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// acc[16 x 8] += A[16 x K] . W[n0 .. n0+8, w0 .. w0+K]^T, with A row-major bf16 in
// shared memory (row stride lda) and W row-major bf16 in device memory (row
// stride ldw): W's rows are the mma's column-major B operand.
__device__ __forceinline__ void mma_rows(float (&acc)[4], const bf16* A, int lda, const bf16* W,
                                         int ldw, int n0, int w0, int K, int g, int t) {
  const bf16* wr = W + (size_t)(n0 + g) * ldw + w0 + 2 * t;
  const bf16* a0 = A + g * lda + 2 * t;
  const bf16* a1 = a0 + 8 * lda;
#pragma unroll 4
  for (int kk = 0; kk < K; kk += 16) {
    const uint32_t a[4] = {lds32(a0 + kk), lds32(a1 + kk), lds32(a0 + kk + 8),
                           lds32(a1 + kk + 8)};
    mma16816(acc, a, ldg32(wr + kk), ldg32(wr + kk + 8));
  }
}

// The same for MT m-tiles (rows 16m .. 16m+15 of A): each B fragment read from
// device memory feeds MT products.
template <int MT>
__device__ __forceinline__ void mma_rows_mt(float (&acc)[MT][4], const bf16* A, int lda,
                                            const bf16* W, int ldw, int n0, int w0, int K, int g,
                                            int t) {
  const bf16* wr = W + (size_t)(n0 + g) * ldw + w0 + 2 * t;
  const bf16* a0 = A + g * lda + 2 * t;
#pragma unroll 4
  for (int kk = 0; kk < K; kk += 16) {
    const uint32_t b0 = ldg32(wr + kk), b1 = ldg32(wr + kk + 8);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* am = a0 + m * 16 * lda;
      const uint32_t a[4] = {lds32(am + kk), lds32(am + 8 * lda + kk), lds32(am + kk + 8),
                             lds32(am + 8 * lda + kk + 8)};
      mma16816(acc[m], a, b0, b1);
    }
  }
}

// LayerNorm of one fp32 row of n values by one warp (two-pass fp32 statistics,
// as the JAX package computes them), written as bf16.
__device__ __forceinline__ void ln_row(const float* x, int n, const float* s, const float* b,
                                       float eps, bf16* y, int lane) {
  float sum = 0.f;
  for (int i = lane; i < n; i += 32) sum += x[i];
  const float mean = warp_sum(sum) / n;
  float sq = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float d = x[i] - mean;
    sq += d * d;
  }
  const float rs = rsqrtf(warp_sum(sq) / n + eps);
  for (int i = lane; i < n; i += 32) y[i] = __float2bfloat16_rn((x[i] - mean) * rs * s[i] + b[i]);
}

__device__ __forceinline__ float gelu_exact(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// The decoder's tail for the 16*MT rows of one CTA, from the fp32 residual x2
// in X (row stride xs) to the logits: h3 = LN3(x2) into Hb (row stride hs),
// X = x2 + bpj + sum_c gelu(h3 . Wfc_c + bfc_c) . Wpj_c over 64-column chunks
// c (the [rows, M] hidden layer is never stored: each chunk goes through GELU
// into the bf16 tile Tt and is multiplied into X at once), then
// out[q0 + r] = LN_post(X_r) . wout + bout with bf16 products and an fp32
// sum. Rows at or past P are computed and not written. Every thread of the
// CTA calls it after a barrier that makes X visible.
template <int MT>
__device__ void mlp_tail(const MlpArgs& a, float* X, int xs, bf16* Hb, int hs, bf16* Tt,
                         long long q0) {
  constexpr int kR = 16 * MT;
  const int W = a.W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  for (int r = warp; r < kR; r += kWarps) {
    float* xr = X + r * xs;
    ln_row(xr, W, a.ln3s, a.ln3b, a.eps, Hb + r * hs, lane);
    for (int i = lane; i < W; i += 32) xr[i] += a.bpj[i];
  }
  __syncthreads();

  for (int c0 = 0; c0 < a.M; c0 += kChunk) {
    for (int nt = warp; nt < kChunk / 8; nt += kWarps) {
      const int n = nt * 8 + 2 * t;
      float acc[MT][4] = {};
      mma_rows_mt<MT>(acc, Hb, hs, a.wfc, W, c0 + nt * 8, 0, W, g, t);
      const float b0 = a.bfc[c0 + n], b1 = a.bfc[c0 + n + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        bf16* tr = Tt + (m * 16 + g) * kTileLd + n;
        *reinterpret_cast<uint32_t*>(tr) = pack(gelu_exact(acc[m][0] + b0),
                                                gelu_exact(acc[m][1] + b1));
        *reinterpret_cast<uint32_t*>(tr + 8 * kTileLd) = pack(gelu_exact(acc[m][2] + b0),
                                                              gelu_exact(acc[m][3] + b1));
      }
    }
    __syncthreads();
    for (int nt = warp; nt < W / 8; nt += kWarps) {
      const int n = nt * 8 + 2 * t;
      float acc[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* xr = X + (m * 16 + g) * xs + n;
        acc[m][0] = xr[0];
        acc[m][1] = xr[1];
        acc[m][2] = xr[8 * xs];
        acc[m][3] = xr[8 * xs + 1];
      }
      mma_rows_mt<MT>(acc, Tt, kTileLd, a.wpj, a.M, nt * 8, c0, kChunk, g, t);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float* xr = X + (m * 16 + g) * xs + n;
        xr[0] = acc[m][0];
        xr[1] = acc[m][1];
        xr[8 * xs] = acc[m][2];
        xr[8 * xs + 1] = acc[m][3];
      }
    }
    __syncthreads();
  }

  for (int r = warp; r < kR; r += kWarps) {
    ln_row(X + r * xs, W, a.lnps, a.lnpb, a.eps, Hb + r * hs, lane);
    __syncwarp();
    float dot = 0.f;
    for (int i = lane; i < W; i += 32)
      dot += __bfloat162float(Hb[r * hs + i]) * __bfloat162float(a.wout[i]);
    dot = warp_sum(dot);
    if (lane == 0 && q0 + r < a.P) a.out[q0 + r] = dot + a.bout;
  }
}

__global__ void __launch_bounds__(kThreads, 1) geo_decode_kernel(const GeoArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.W, D = a.D, L = a.L;
  const int xs = W + 8, hs = W + 8, ss = L + 8;
  float* X = reinterpret_cast<float*>(smem);           // [16][W+8] fp32 residual
  bf16* Hb = reinterpret_cast<bf16*>(X + kRows * xs);  // [16][W+8] bf16 activations
  float* S = reinterpret_cast<float*>(Hb + kRows * hs);  // [16][L+8] scores
  bf16* Pb = reinterpret_cast<bf16*>(S + kRows * ss);    // [16][L+8] probabilities
  float* QM = reinterpret_cast<float*>(Pb + kRows * ss);  // [16][136] one head's q
  bf16* Tt = reinterpret_cast<bf16*>(QM + kRows * kTileLd);  // [16][136] small tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows;

  // ---- Fourier embedding [x | sin(x 2^f) | cos(x 2^f)], channel-major ----
  const int F = a.num_freqs, edim = 3 * (2 * F + 1);
  for (int i = threadIdx.x; i < kRows * kEmb; i += kThreads) {
    const int r = i / kEmb, c = i % kEmb, q = q0 + r;
    float val = 0.f;
    if (q < a.P && c < edim) {
      if (c < 3) {
        val = a.pts[(size_t)q * 3 + c];
      } else {
        const int j = (c - 3) % (3 * F);
        const float e = a.pts[(size_t)q * 3 + j / F] * (exp2f((float)(j % F)) * a.freq_mul);
        val = (c - 3 < 3 * F) ? sinf(e) : cosf(e);
      }
    }
    Tt[r * kTileLd + c] = __float2bfloat16_rn(val);
  }
  __syncthreads();

  // ---- x = qe . Wqp + bqp (fp32 residual) ----
  for (int nt = warp; nt < W / 8; nt += kWarps) {
    const int n = nt * 8 + 2 * t;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    mma_rows(acc, Tt, kTileLd, a.wqp, kEmb, nt * 8, 0, kEmb, g, t);
    X[g * xs + n] = acc[0] + a.bqp[n];
    X[g * xs + n + 1] = acc[1] + a.bqp[n + 1];
    X[(g + 8) * xs + n] = acc[2] + a.bqp[n];
    X[(g + 8) * xs + n + 1] = acc[3] + a.bqp[n + 1];
  }
  __syncthreads();
  for (int r = warp; r < kRows; r += kWarps)
    ln_row(X + r * xs, W, a.ln1s, a.ln1b, a.eps, Hb + r * hs, lane);
  __syncthreads();

  // ---- cross-attention, head by head; c_proj accumulated into X ----
  for (int h = 0; h < a.H; ++h) {
    const bf16* kh = a.k + (size_t)h * L * D;
    const bf16* vh = a.v + (size_t)h * L * D;
    for (int nt = warp; nt < D / 8; nt += kWarps) {  // q = LN1(x) . Wcq (this head)
      const int n = nt * 8 + 2 * t;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows(acc, Hb, hs, a.wcq, W, h * D + nt * 8, 0, W, g, t);
      QM[g * kTileLd + n] = acc[0] + a.bcq[h * D + n];
      QM[g * kTileLd + n + 1] = acc[1] + a.bcq[h * D + n + 1];
      QM[(g + 8) * kTileLd + n] = acc[2] + a.bcq[h * D + n];
      QM[(g + 8) * kTileLd + n + 1] = acc[3] + a.bcq[h * D + n + 1];
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps)  // per-head q LayerNorm
      ln_row(QM + r * kTileLd, D, a.qns, a.qnb, a.eps, Tt + r * kTileLd, lane);
    __syncthreads();
    for (int nt = warp; nt < L / 8; nt += kWarps) {  // scores = q . k^T * scale
      const int n = nt * 8 + 2 * t;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows(acc, Tt, kTileLd, kh, D, nt * 8, 0, D, g, t);
      S[g * ss + n] = acc[0] * a.scale;
      S[g * ss + n + 1] = acc[1] * a.scale;
      S[(g + 8) * ss + n] = acc[2] * a.scale;
      S[(g + 8) * ss + n + 1] = acc[3] * a.scale;
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {  // exact fp32 softmax
      const float* sr = S + r * ss;
      float mx = -INFINITY;
      for (int i = lane; i < L; i += 32) mx = fmaxf(mx, sr[i]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < L; i += 32) sum += expf(sr[i] - mx);
      sum = warp_sum(sum);
      for (int i = lane; i < L; i += 32) Pb[r * ss + i] = __float2bfloat16_rn(expf(sr[i] - mx) / sum);
    }
    __syncthreads();
    for (int nt = warp; nt < D / 8; nt += kWarps) {  // o = p . v, rounded to bf16
      const int n = nt * 8 + 2 * t;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* vc = vh + nt * 8 + g;
      const bf16* p0 = Pb + g * ss + 2 * t;
      const bf16* p1 = p0 + 8 * ss;
#pragma unroll 4
      for (int kk = 0; kk < L; kk += 16) {
        const uint32_t af[4] = {lds32(p0 + kk), lds32(p1 + kk), lds32(p0 + kk + 8),
                                lds32(p1 + kk + 8)};
        const bf16* vk = vc + (size_t)(kk + 2 * t) * D;
        mma16816(acc, af, pack_raw(vk[0], vk[D]), pack_raw(vk[8 * D], vk[9 * D]));
      }
      *reinterpret_cast<uint32_t*>(Tt + g * kTileLd + n) = pack(acc[0], acc[1]);
      *reinterpret_cast<uint32_t*>(Tt + (g + 8) * kTileLd + n) = pack(acc[2], acc[3]);
    }
    __syncthreads();
    for (int nt = warp; nt < W / 8; nt += kWarps) {  // X += o . Wcp[:, head]
      const int n = nt * 8 + 2 * t;
      float acc[4] = {X[g * xs + n], X[g * xs + n + 1], X[(g + 8) * xs + n],
                      X[(g + 8) * xs + n + 1]};
      mma_rows(acc, Tt, kTileLd, a.wcp, W, nt * 8, h * D, D, g, t);
      X[g * xs + n] = acc[0];
      X[g * xs + n + 1] = acc[1];
      X[(g + 8) * xs + n] = acc[2];
      X[(g + 8) * xs + n + 1] = acc[3];
    }
    // the next head's first write to Tt comes after the barrier below its
    // q product, which every warp reaches only after this loop
  }
  __syncthreads();

  // ---- x2 = x + attn . Wcp + bcp, then the MLP tail ----
  for (int r = warp; r < kRows; r += kWarps) {
    float* xr = X + r * xs;
    for (int i = lane; i < W; i += 32) xr[i] += a.bcp[i];
  }
  __syncthreads();
  const MlpArgs tail = {nullptr, a.ln3s, a.ln3b, a.wfc, a.bfc, a.wpj, a.bpj, a.lnps, a.lnpb,
                        a.wout, a.out, a.P, W, a.M, a.eps, a.bout};
  mlp_tail<1>(tail, X, xs, Hb, hs, Tt, q0);
}

constexpr int kMlpTiles = 2;                // kernel 4: m-tiles per CTA
constexpr int kMlpRows = 16 * kMlpTiles;    // 32 rows of x2 per CTA

size_t mlp_smem_bytes(int W) {
  return sizeof(float) * kMlpRows * (W + 8) + sizeof(bf16) * kMlpRows * (W + 8) +
         sizeof(bf16) * kMlpRows * kTileLd;
}

__global__ void __launch_bounds__(kThreads, 1) geo_mlp_kernel(const MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.W;
  const int xs = W + 8, hs = W + 8;
  float* X = reinterpret_cast<float*>(smem);              // [32][W+8] fp32 residual
  bf16* Hb = reinterpret_cast<bf16*>(X + kMlpRows * xs);  // [32][W+8] bf16 LN outputs
  bf16* Tt = Hb + kMlpRows * hs;                          // [32][136] GELU tile
  const long long q0 = (long long)blockIdx.x * kMlpRows;

  // x2 rows -> fp32 residual, 16-byte loads (8 bf16); rows at or past P are 0
  const int per_row = W / 8;
  for (int i = threadIdx.x; i < kMlpRows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    float* xr = X + r * xs + c;
    if (q0 + r < a.P) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(a.x2 + (size_t)(q0 + r) * W + c));
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) xr[j] = __bfloat162float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xr[j] = 0.f;
    }
  }
  __syncthreads();
  mlp_tail<kMlpTiles>(a, X, xs, Hb, hs, Tt, q0);
}

size_t smem_bytes(int W, int L) {
  return sizeof(float) * kRows * (W + 8) + sizeof(bf16) * kRows * (W + 8) +
         sizeof(float) * kRows * (L + 8) + sizeof(bf16) * kRows * (L + 8) +
         sizeof(float) * kRows * kTileLd + sizeof(bf16) * kRows * kTileLd;
}

}  // namespace

// Shared memory the kernel needs for width W and L latent tokens (bytes).
extern "C" size_t hy3d_geo_decode_smem(int W, int L) { return smem_bytes(W, L); }

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// Shapes the kernel does not take return cudaErrorInvalidValue.
extern "C" int hy3d_geo_decode(const GeoArgs* args, void* stream) {
  const GeoArgs& a = *args;
  if (a.P <= 0 || (a.D != 64 && a.D != 128) || a.W % 128 != 0 || a.W != a.H * a.D ||
      a.L <= 0 || a.L % 16 != 0 || a.L > 1024 || a.M % kChunk != 0 || a.num_freqs < 1 ||
      3 * (2 * a.num_freqs + 1) > kEmb)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.W, a.L);
  cudaError_t err = cudaFuncSetAttribute(geo_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.P + kRows - 1) / kRows;
  geo_decode_kernel<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The MLP tail of the streamed decode (kernel 4) on `stream`; returns the
// cudaError_t of the launch (0 on success). Shapes the kernel does not take
// (W not a multiple of 128, M not a multiple of 64, or more shared memory
// than a block has, i.e. W > 1152) return cudaErrorInvalidValue.
extern "C" int hy3d_geo_mlp(const MlpArgs* args, void* stream) {
  const MlpArgs& a = *args;
  const size_t smem = mlp_smem_bytes(a.W);
  if (a.P <= 0 || a.W <= 0 || a.W % 128 != 0 || a.M <= 0 || a.M % kChunk != 0 ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(geo_mlp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)a.P + kMlpRows - 1) / kMlpRows;
  geo_mlp_kernel<<<(unsigned)tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
