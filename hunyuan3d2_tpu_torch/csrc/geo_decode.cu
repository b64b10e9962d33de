// The ShapeVAE geo decoder on Hopper (sm_90a), as a chain of hand-written
// kernels: LayerNorm row kernels and one warp-specialised wgmma + TMA GEMM
// template with fused epilogues.
//
// Replaces two Pallas TPU kernels of hunyuan3d2_tpu/ops/geo_decoder_pallas.py:
//  * kernel 3, `fused_geo_decode` -> `_kernel` (the pallas_call at :221, body
//    :91-136): the whole decoder for a query tile at <= 1024 latents;
//  * kernel 4, `fused_geo_decode_stream` -> `_geo_mlp_kernel` (the
//    pallas_call at :377, body :274-296): the streamed decode's MLP tail.
// The Python side (ops/geo_decoder.py) composes them:
//   kernel 3: x = qe . Wqp^T + bqp (GEMM, E2) -> h1 = bf16(LN1(x)) (rows) ->
//             q = bf16(qLN_head(h1 . Wcq^T + bcq)) as [H, P, D] (GEMM, E3) ->
//             o = flash attention (flash_attention.cu) ->
//             x2 = x + o . Wcp^T + bcp, fp32 (GEMM, E2, A read per head) ->
//             the tail;
//   kernel 4 (the tail): h = bf16(LN3(x2)) (rows) ->
//             T = bf16(gelu(h . Wfc^T + bfc)) (GEMM, E1) ->
//             y = x2 + bpj + T . Wpj^T, fp32 (GEMM, E2) ->
//             out = bf16(LN_post(y)) . wout + bout (rows, dot).
// Every rounding point of the Pallas kernels stays where it was: T is the
// bf16 value the Pallas kernel feeds its second product; only the order of
// fp32 sums differs (the Pallas kernel sums the MLP in column chunks). GELU
// uses the Pallas kernels' own erf (A&S 7.1.26, error <= 1.5e-7).
//
// What bounds it on the H100: the products. Per query the tail does 4 W M
// operations (16.8 MFLOP at W 1024, M 4096) against ~2 W bytes in, so it is
// operations-bound (3.4 ms of bf16 tensor-core time at P = 199,680). The
// TPU kernel keeps a [256, W] fp32 residual in VMEM through the whole chain;
// a 128-row wgmma tile's residual (512 KB at W 1024) fits neither the 227 KB
// of shared memory nor the register file of one SM. So the chain is cut
// where the Pallas kernel rounds to bf16 or needs a whole row, and each
// piece is a kernel that Hopper runs well; the pieces move ~6.6 GB more
// through device memory at the fine chunk (~2 ms at 3.35 TB/s), mostly
// overlapped by the products, and each weight tile read from the L2 now
// serves 128 rows instead of 16 or 32.
//
// GEMM design (`gemm_kernel`): C = epilogue(A . B^T), A [rows, K] and B
// [N, K] bf16 (B in torch's [out, in] layout, the K-major operand wgmma
// wants), fp32 accumulation in registers.
//  * A CTA computes a 128 x 256 tile with 3 warpgroups: warpgroup 0 is the
//    producer (one thread keeps a 4-stage TMA ring of (A, B) K-tiles of 64
//    in flight, 48 KB a stage, 128-byte swizzle, zero fill past the rows),
//    warpgroups 1 and 2 consume 64 rows each with wgmma m64n256k16 (both
//    operands in shared memory) into 128 fp32 registers a thread;
//    setmaxnreg moves the producer's registers to the consumers.
//  * One product group stays in flight: a stage is released as soon as the
//    products of the next K-tile have been issued.
//  * Two CTAs of a cluster take two row tiles of the same 256 columns: each
//    loads its own A tile and one half of the shared B tile, multicast into
//    both, so a CTA reads 32 KB a stage from the L2 instead of 48. At
//    48 KB per 4.2 MFLOP the L2 (~6 TB/s) held a CTA pair to ~540 TFLOP/s;
//    a stage is reused once the consumers of both CTAs have released it.
//  * The epilogue runs on the registers and stores straight to device
//    memory, rows past `rows` skipped: (E1) bias + exact GELU -> bf16;
//    (E2) bias + an optional residual (bf16 or fp32) -> fp32 or bf16;
//    (E3) bias + LayerNorm over each D-column head (the quad's 4 threads
//    hold a row's D columns: two shuffles per statistic) -> bf16 stored as
//    [N / D, rows, D], the flash kernel's q layout.
//  * A is read through a 3-D tensor map (inner, rows, K / inner): inner = K
//    for a plain row-major A, inner = D to read the flash kernel's [H, P, D]
//    output as [P, H D] with no merge-heads copy.
//  * Persistent: as many clusters as the card holds (one CTA per SM) walk
//    the cluster tiles (256 columns of two row tiles), 256-column tiles
//    fastest, so the CTAs that share an A row tile run together and read it
//    from the L2; B (the weights, <= 8 MB) stays resident in the 50 MB L2.
//    The producer runs on into the next tile's K-tiles while the consumers
//    run a tile's epilogue, so the ring is full when they come back.
//  * E2 loads the residuals of 8 column groups at a time, so their
//    latencies overlap.
// Row kernels (`rows_kernel`): one warp per row, 16-byte loads, two-pass
// fp32 statistics with the row cached in registers (W <= 1024; wider rows
// are read again from L1), the LN output rounded to bf16 and either stored
// or dotted with wout in fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// GEMM with fused epilogues
// ---------------------------------------------------------------------------
constexpr int kBM = 128;                  // rows of a CTA tile (two consumer warpgroups)
constexpr int kBN = 256;                  // columns of a CTA tile
constexpr int kBK = 64;                   // K-tile: one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kCluster = 2;               // row tiles of a cluster, sharing each B tile
constexpr int kBHalf = kBN / kCluster;    // B rows each CTA of a cluster loads for both
constexpr int kGemmThreads = 384;
constexpr int kABytes = kBM * kBK * 2;    // 16 KB
constexpr int kBBytes = kBN * kBK * 2;    // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOffBar = kStages * kStageBytes;
constexpr int kGemmSmem = 1024 + kOffBar + 16 * kStages;  // + alignment slack
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

enum Epi { kGelu = 0, kResidual = 1, kHeadLn = 2 };

struct GemmArgs {
  const float* bias;   // [N]
  const void* resid;   // [rows, N] (E2) or null
  const float* ln_s;   // [D] (E3)
  const float* ln_b;   // [D] (E3)
  void* out;
  int rows, n;
  float eps;
};

// Exact GELU with the Pallas kernels' erf (Abramowitz & Stegun 7.1.26,
// |error| <= 1.5e-7, geo_decoder_pallas.py:77-88): one reciprocal, one
// exponential and five FMAs, about half of erff's instructions.
__device__ __forceinline__ float gelu_exact(float z) {
  const float x = z * 0.70710678118654752f, ax = fabsf(x);
  const float t = __fdividef(1.f, fmaf(0.3275911f, ax, 1.f));
  const float poly =
      fmaf(fmaf(fmaf(fmaf(1.061405429f, t, -1.453152027f), t, 1.421413741f), t, -0.284496736f), t,
           0.254829592f) *
      t;
  return 0.5f * z * (1.f + copysignf(1.f - poly * __expf(-ax * ax), x));
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// The epilogue of one tile on the registers: thread t of the warpgroup
// holds rows r0 and r0 + 8 and, of every 8 columns, columns c0 + 8 i and
// c0 + 8 i + 1 (c0 = n0 + 2 (t % 4)).
template <int kEpi, int D, typename ResT, typename OutT>
__device__ __forceinline__ void epilogue(float (&acc)[kBN / 2], const GemmArgs& g, int r0, int c0,
                                         int n0, int lane) {
  if constexpr (kEpi == kHeadLn) {
    // per-head LayerNorm over each D-column group; every lane of the quad
    // runs the shuffles, rows past `rows` are computed and not stored
    constexpr int kPer = D / 8;  // 8-column groups of a head
    const int H = g.n / D;
#pragma unroll
    for (int j = 0; j < kBN / D; ++j) {
#pragma unroll
      for (int i = j * kPer; i < (j + 1) * kPer; ++i) {
        const int n = c0 + 8 * i;
        const float b0 = n < g.n ? g.bias[n] : 0.f, b1 = n < g.n ? g.bias[n + 1] : 0.f;
        acc[4 * i] += b0;
        acc[4 * i + 1] += b1;
        acc[4 * i + 2] += b0;
        acc[4 * i + 3] += b1;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float sum = 0.f;
#pragma unroll
        for (int i = j * kPer; i < (j + 1) * kPer; ++i) sum += acc[4 * i + 2 * hr] + acc[4 * i + 2 * hr + 1];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float mean = sum / D;
        float sq = 0.f;
#pragma unroll
        for (int i = j * kPer; i < (j + 1) * kPer; ++i) {
          const float d0 = acc[4 * i + 2 * hr] - mean, d1 = acc[4 * i + 2 * hr + 1] - mean;
          sq += d0 * d0 + d1 * d1;
        }
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        const float rs = rsqrtf(sq / D + g.eps);
        const int r = r0 + 8 * hr;
        const int h = (n0 + j * D) / D;
        if (r < g.rows && h < H) {
          bf16* q = static_cast<bf16*>(g.out) + ((size_t)h * g.rows + r) * D;
#pragma unroll
          for (int i = j * kPer; i < (j + 1) * kPer; ++i) {
            const int d = 8 * (i - j * kPer) + 2 * (lane % 4);
            store2<bf16>(q + d, (acc[4 * i + 2 * hr] - mean) * rs * g.ln_s[d] + g.ln_b[d],
                         (acc[4 * i + 2 * hr + 1] - mean) * rs * g.ln_s[d + 1] + g.ln_b[d + 1]);
          }
        }
      }
    }
  } else {
    // 8 column groups at a time: their residuals are loaded together, so
    // the loads' latencies overlap
    constexpr int kGroup = 8;
#pragma unroll
    for (int i0 = 0; i0 < kBN / 8; i0 += kGroup) {
      float2 res[kGroup][2];
      if constexpr (!std::is_void<ResT>::value) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int n = c0 + 8 * (i0 + i), r = r0 + 8 * hr;
            res[i][hr] = (n < g.n && r < g.rows)
                             ? load2<ResT>(static_cast<const ResT*>(g.resid) + (size_t)r * g.n + n)
                             : make_float2(0.f, 0.f);
          }
      }
#pragma unroll
      for (int i = i0; i < i0 + kGroup; ++i) {
        const int n = c0 + 8 * i;
        if (n >= g.n) continue;
        const float b0 = g.bias[n], b1 = g.bias[n + 1];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + 8 * hr;
          if (r >= g.rows) continue;
          float v0 = acc[4 * i + 2 * hr], v1 = acc[4 * i + 2 * hr + 1];
          if constexpr (kEpi == kGelu) {
            v0 = gelu_exact(v0 + b0);
            v1 = gelu_exact(v1 + b1);
          } else {
            float a0 = b0, a1 = b1;
            if constexpr (!std::is_void<ResT>::value) {
              a0 = res[i - i0][hr].x + b0;
              a1 = res[i - i0][hr].y + b1;
            }
            v0 = a0 + v0;
            v1 = a1 + v1;
          }
          store2<OutT>(static_cast<OutT*>(g.out) + (size_t)r * g.n + n, v0, v1);
        }
      }
    }
  }
}

// A consumer warp is done with a ring stage in this CTA: one arrival on the
// stage's mbarrier in each CTA of the cluster, whose producers both write it.
__device__ __forceinline__ void release_stage(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0)
    for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(empty, c);
}

// ResT: the residual's type (void: none); OutT: the output's; D: the head
// size of E3 (unused elsewhere).
template <int kEpi, int D, typename ResT, typename OutT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kGemmThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const GemmArgs g, int nk, int a_inner) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t rank = cluster_ctarank();
  // persistent: cluster c takes cluster tiles c, c + clusters, ...; a
  // cluster tile is 256 columns (n fastest) of two row tiles, one per CTA
  const int n_tiles = (g.n + kBN - 1) / kBN;
  const int tiles = n_tiles * ((g.rows + kCluster * kBM - 1) / (kCluster * kBM));
  const int first = blockIdx.x / kCluster, step = gridDim.x / kCluster;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * kCluster);  // the consumer warps of both CTAs
    }
    fence_barrier_init();
  }
  cluster_sync();  // both CTAs' barriers exist before either multicasts or arrives

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      int it = 0;  // K-tiles loaded so far, over every tile: the ring position
      for (int t = first; t < tiles; t += step) {
        const int n0 = (t % n_tiles) * kBN, m0 = ((t / n_tiles) * kCluster + rank) * kBM;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages, k0 = kt * kBK;
          uint8_t* as = smem + s * kStageBytes;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load_3d(as, &ta, &full[s], k0 % a_inner, m0, k0 / a_inner);
          // this CTA's half of the shared B tile, into both CTAs
          tma_load_3d_multicast(as + kABytes + rank * kBHalf * 128, &tb, &full[s],
                                (1u << kCluster) - 1, k0, n0 + rank * kBHalf, 0);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each ----
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  int it = 0;
  for (int t = first; t < tiles; t += step) {
    const int n0 = (t % n_tiles) * kBN, m0 = ((t / n_tiles) * kCluster + rank) * kBM;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      const uint8_t* as = smem + s * kStageBytes + cw * 64 * 128;
      const uint8_t* bs = smem + s * kStageBytes + kABytes;
      mbar_wait(&full[s], (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss<kBN>(acc, desc_kmajor(as + kk * 32), desc_kmajor(bs + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous K-tile's products are done
      if (kt > 0) release_stage(&empty[(it - 1) % kStages], lane);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release_stage(&empty[(it - 1) % kStages], lane);
    // the producer fills the ring with the next tile's K-tiles meanwhile
    epilogue<kEpi, D, ResT, OutT>(acc, g, m0 + cw * 64 + (tid / 32) * 16 + lane / 4,
                                  n0 + 2 * (lane % 4), n0, lane);
  }
  // no remote arrive is left in flight when either CTA of the pair exits
  cluster_sync();
}

template <int kEpi, int D, typename ResT, typename OutT>
cudaError_t launch_gemm(const void* a, int a_inner, const void* b, const GemmArgs& g, int k,
                        cudaStream_t stream) {
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap ta, tb;
  if (!encode_3d(&ta, bf, 2, a, a_inner, g.rows, k / a_inner, kBK, kBM, sw) ||
      !encode_3d(&tb, bf, 2, b, k, g.n, 1, kBK, kBHalf, sw))
    return cudaErrorInvalidDevicePointer;  // the driver refused a tensor map
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<kEpi, D, ResT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (attr != cudaSuccess) return attr;
  // as many clusters as the card holds at once (one CTA per SM), at most one
  // per cluster tile; the row tiles are rounded up to whole clusters (a tile
  // past the rows loads zeros, which TMA fills, and stores nothing)
  static int resident = 0;
  static const cudaError_t occ = [] {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kGemmThreads);
    cfg.dynamicSmemBytes = kGemmSmem;
    return cudaOccupancyMaxActiveClusters(&resident, gemm_kernel<kEpi, D, ResT, OutT>, &cfg);
  }();
  if (occ != cudaSuccess) return occ;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const long long tiles =
      (long long)((g.n + kBN - 1) / kBN) * ((g.rows + kCluster * kBM - 1) / (kCluster * kBM));
  const int clusters = (int)(tiles < resident ? tiles : resident);
  gemm_kernel<kEpi, D, ResT, OutT><<<kCluster * clusters, kGemmThreads, kGemmSmem, stream>>>(
      ta, tb, g, k / kBK, a_inner);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// LayerNorm rows
// ---------------------------------------------------------------------------
constexpr int kRowWarps = 8;
constexpr int kCachedChunks = 8;  // 128-column chunks a lane keeps in registers (W <= 1024)

struct RowArgs {
  const void* x;       // [rows, W] fp32 or bf16
  const float* s;      // [W]
  const float* b;      // [W]
  bf16* y;             // [rows, W] (LN out) or null
  const bf16* wout;    // [W] (dot) or null
  const float* bout;   // [1] (dot)
  float* out;          // [rows] (dot)
  int rows, w;
  float eps;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// LN of one row per warp: y = bf16((x - mean) rsqrt(var + eps) s + b),
// stored (kDot false) or dotted with wout into out[row] = sum y wout + bout
// (kDot true). Lane l owns columns 128 c + 4 l .. + 3 of every 128-column
// chunk c; kCached keeps them in registers between the passes, otherwise
// each pass reads them again (from L1).
template <typename InT, bool kDot, bool kCached>
__global__ void __launch_bounds__(32 * kRowWarps) rows_kernel(const RowArgs a) {
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (r >= a.rows) return;
  const int nc = a.w / 128;
  const InT* x = static_cast<const InT*>(a.x) + r * a.w + 4 * lane;
  float v[kCached ? kCachedChunks : 1][4];
  // chunk c of this lane's columns, from registers or read again
  auto chunk = [&](int c, float (&u)[4]) {
    if constexpr (kCached) {
#pragma unroll
      for (int e = 0; e < 4; ++e) u[e] = v[c][e];
    } else {
      load4(x + 128 * c, u);
    }
  };
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < (kCached ? kCachedChunks : nc); ++c) {
    if (c >= nc) break;
    float u[4];
    if constexpr (kCached) load4(x + 128 * c, v[c]);
    chunk(c, u);
    sum += (u[0] + u[1]) + (u[2] + u[3]);
  }
  const float mean = warp_sum(sum) / a.w;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < (kCached ? kCachedChunks : nc); ++c) {
    if (c >= nc) break;
    float u[4];
    chunk(c, u);
#pragma unroll
    for (int e = 0; e < 4; ++e) sq += (u[e] - mean) * (u[e] - mean);
  }
  const float rs = rsqrtf(warp_sum(sq) / a.w + a.eps);
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < (kCached ? kCachedChunks : nc); ++c) {
    if (c >= nc) break;
    float u[4];
    chunk(c, u);
    const int col = 128 * c + 4 * lane;
    const float4 s = *reinterpret_cast<const float4*>(a.s + col);
    const float4 b = *reinterpret_cast<const float4*>(a.b + col);
    const uint32_t lo = pack_bf16((u[0] - mean) * rs * s.x + b.x, (u[1] - mean) * rs * s.y + b.y);
    const uint32_t hi = pack_bf16((u[2] - mean) * rs * s.z + b.z, (u[3] - mean) * rs * s.w + b.w);
    if (kDot) {
      const uint2 yy = make_uint2(lo, hi);
      float y[4], w[4];
      load4(reinterpret_cast<const bf16*>(&yy), y);
      load4(a.wout + col, w);
      dot += (y[0] * w[0] + y[1] * w[1]) + (y[2] * w[2] + y[3] * w[3]);
    } else {
      *reinterpret_cast<uint2*>(a.y + r * a.w + col) = make_uint2(lo, hi);
    }
  }
  if (kDot) {
    dot = warp_sum(dot);
    if (lane == 0) a.out[r] = dot + a.bout[0];
  }
}

template <typename InT, bool kDot>
cudaError_t launch_rows(const RowArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((long long)a.rows + kRowWarps - 1) / kRowWarps);
  if (a.w <= 128 * kCachedChunks)
    rows_kernel<InT, kDot, true><<<blocks, 32 * kRowWarps, 0, stream>>>(a);
  else
    rows_kernel<InT, kDot, false><<<blocks, 32 * kRowWarps, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// C = epilogue(A . B^T) on `stream`. dtype codes: 0 none, 1 bf16, 2 fp32.
//  epi 0 (E1): out bf16 [rows, n] = gelu(acc + bias);
//  epi 1 (E2): out [rows, n] (out_dtype) = (resid + bias) + acc, resid of
//              res_dtype (0: none; resid may alias out when both are fp32);
//  epi 2 (E3): out bf16 [n / head_dim, rows, head_dim] = per-head
//              LN(acc + bias) * ln_s + ln_b, head_dim 64 or 128.
// A is bf16, read as [rows, k] from a [k / a_inner, rows, a_inner] array
// (a_inner = k: plain row-major); B is bf16 [n, k]. Needs k % 64 == 0,
// a_inner % 64 == 0 and k % a_inner == 0, n % 8 == 0, 16-byte aligned A, B
// and out. Returns the cudaError_t of the launch (0 on success);
// unsupported arguments return cudaErrorInvalidValue.
extern "C" int hy3d_gemm(int epi, int head_dim, int res_dtype, int out_dtype, const void* a,
                         int a_inner, const void* b, const float* bias, const void* resid,
                         const float* ln_s, const float* ln_b, void* out, int rows, int n, int k,
                         float eps, void* stream) {
  if (rows <= 0 || n <= 0 || n % 8 || k <= 0 || k % kBK || a_inner <= 0 || a_inner % kBK ||
      k % a_inner || !aligned16(a) || !aligned16(b) || !aligned16(out) || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  const GemmArgs g{bias, resid, ln_s, ln_b, out, rows, n, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epi == kGelu && res_dtype == 0 && out_dtype == 1)
    return (int)launch_gemm<kGelu, 0, void, bf16>(a, a_inner, b, g, k, st);
  if (epi == kResidual) {
    if (res_dtype != 0 && resid == nullptr) return (int)cudaErrorInvalidValue;
    if (res_dtype == 0 && out_dtype == 2)
      return (int)launch_gemm<kResidual, 0, void, float>(a, a_inner, b, g, k, st);
    if (res_dtype == 2 && out_dtype == 2)
      return (int)launch_gemm<kResidual, 0, float, float>(a, a_inner, b, g, k, st);
    if (res_dtype == 2 && out_dtype == 1)
      return (int)launch_gemm<kResidual, 0, float, bf16>(a, a_inner, b, g, k, st);
    if (res_dtype == 1 && out_dtype == 2)
      return (int)launch_gemm<kResidual, 0, bf16, float>(a, a_inner, b, g, k, st);
  }
  if (epi == kHeadLn && res_dtype == 0 && out_dtype == 1 && ln_s != nullptr && ln_b != nullptr &&
      n % head_dim == 0) {
    if (head_dim == 64) return (int)launch_gemm<kHeadLn, 64, void, bf16>(a, a_inner, b, g, k, st);
    if (head_dim == 128) return (int)launch_gemm<kHeadLn, 128, void, bf16>(a, a_inner, b, g, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

// LayerNorm rows on `stream`: x [rows, w] of in_dtype (1 bf16, 2 fp32).
// dot 0: y [rows, w] bf16 = LN(x) s + b; dot 1 (fp32 x only): out [rows]
// fp32 = sum bf16(LN(x) s + b) wout + bout[0]. Needs w % 128 == 0 and
// 16-byte aligned x, s, b, y / wout. Returns the cudaError_t of the launch.
extern "C" int hy3d_ln_rows(int in_dtype, int dot, const void* x, const float* s, const float* b,
                            void* y, const void* wout, const float* bout, float* out, int rows,
                            int w, float eps, void* stream) {
  if (rows <= 0 || w <= 0 || w % 128 || !aligned16(x) || !aligned16(s) || !aligned16(b))
    return (int)cudaErrorInvalidValue;
  const RowArgs a{x, s, b, static_cast<bf16*>(y), static_cast<const bf16*>(wout), bout, out,
                  rows, w, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dot == 0 && y != nullptr && aligned16(y)) {
    if (in_dtype == 1) return (int)launch_rows<bf16, false>(a, st);
    if (in_dtype == 2) return (int)launch_rows<float, false>(a, st);
  }
  if (dot == 1 && in_dtype == 2 && wout != nullptr && bout != nullptr && out != nullptr &&
      aligned16(wout))
    return (int)launch_rows<float, true>(a, st);
  return (int)cudaErrorInvalidValue;
}
