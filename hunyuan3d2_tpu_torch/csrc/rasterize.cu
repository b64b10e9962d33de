// Z-buffer triangle rasterizer for Hopper (sm_90a), face setup included.
//
// Replaces the Pallas TPU kernel hunyuan3d2_tpu/ops/rasterize_tpu.py
// `rasterize_tpu` -> `_kernel` (the pallas_call at :301, body :88-148, its
// face setup at :178-215). Same function as ops/rasterize.py's plain twin
// (`face_setup` + `rasterize_plain`): clip-space vertices go to screen
// space, sx = (x/w*0.5+0.5)*(W-1), sy = (0.5-y/w*0.5)*(H-1), depth
// sz = z/w*0.5+0.5 (w == 0 taken as 1e-8); a face is culled when
// |area| < 1e-12 (a NaN area included) or when it lies off screen; a pixel
// (x, y) at integer coordinates is covered when its edge functions
// w0 = (c0 + a0*x) + b0*y, w1 = (c1 + a1*x) + b1*y and w2 = (1 - w0) - w1
// are all >= 0 (either winding); its depth z = clamp((zc + w0*z0) + w1*z1,
// 0, 1); the nearest fp32 depth wins and a depth tie goes to the lowest face
// id. Outputs face_id (-1 where empty), (w0, w1, w2) and depth (0 where
// empty). Every operation is __fdiv_rn / __fmul_rn / __fadd_rn / __fsub_rn:
// no FMA contraction, so the records are bit-identical to face_setup's
// (one PyTorch kernel per operation, each rounded) and edge pixels go to
// the same faces as in the plain twin.
//
// Design. The TPU kernel bins faces to 128-pixel tiles and sweeps each
// tile's face list in VMEM with capacities that can overflow. Here:
//  * kernel 1 (`setup_bin`), one thread per face: the records and bbox,
//    then the face's id is appended to the list of each 32x32 screen tile
//    its bbox touches (at most kMaxTiles of them; the lanes of a warp that
//    append to one tile share one global atomicAdd). A face that spans more
//    tiles, or that finds a tile list full, goes to one device-wide "wide"
//    list instead (as well). Every tile sweeps the wide list with a bbox
//    test, so nothing can overflow and no count goes back to the host.
//  * kernel 2 (`raster_tiles`), one CTA of 256 threads per tile: the tile's
//    32x32 tokens float_bits(z) << 32 | face_id live in shared memory (z in
//    [0, 1], -0 folded to +0, where float bits order like the values). The
//    tile's list, then the wide list, is taken in rounds of 256 faces, a
//    thread per face: it stages the face's records and its bbox clipped to
//    the tile in shared memory, a block scan lays the round's (face, pixel)
//    pairs end to end, and each thread takes an equal run of them (a binary
//    search finds its first face), so a 512^2 view's ~500 small faces per
//    tile and a UV raster's few larger ones keep every lane busy alike. A
//    covered pixel takes a 64-bit shared atomicMin after a plain read that
//    skips occluded pixels. The minimum token is the strict `z < best`
//    sweep in ascending face order whatever the order of the lists. After a
//    barrier the same CTA decodes its tokens, recomputes w0, w1 of the
//    winning face and writes face_id, bary and depth once each, a warp per
//    tile row.
// One memset clears the tile counts; no global z-buffer is cleared, no
// global atomic is taken per (face, pixel) pair, and no resolve pass runs
// apart.
//
// What bounds it on the H100: at the paint path's sizes (about 40k faces,
// 512^2 cond maps, 2048^2 UV and bake rasters) the least work is reading
// the vertices and faces and writing 20 bytes per pixel: 2 us at 512^2,
// 25 us at 2048^2. The kernels take ~45 and ~65 us there: a 512^2 view is
// 256 tiles (two CTAs per SM), each a chain of dependent loads, scans and
// shared atomics; a 2048^2 raster is 4096 short CTAs whose fixed costs and
// 84 MB of stores set the pace.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRec = 9;            // a0 b0 c0 a1 b1 c1 z0 z1 zc
constexpr int kTile = 32;          // screen tile edge, pixels
constexpr int kMaxTiles = 4;       // a face on more tiles goes to the wide list
constexpr int kSetupThreads = 128;
constexpr int kTileThreads = 256;  // 8 warps per tile
constexpr int kWarps = kTileThreads / 32;
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ float edge(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(c, __fmul_rn(a, px)), __fmul_rn(b, py));
}

// torch's amin / amax over three values: NaN if any is NaN
__device__ __forceinline__ float min3(float a, float b, float c) {
  if (isnan(a) || isnan(b) || isnan(c)) return __int_as_float(0x7fffffff);
  return fminf(fminf(a, b), c);
}
__device__ __forceinline__ float max3(float a, float b, float c) {
  if (isnan(a) || isnan(b) || isnan(c)) return __int_as_float(0x7fffffff);
  return fmaxf(fmaxf(a, b), c);
}

// torch's clamp(lo, hi) (NaN stays NaN) followed by nan_to_num(0) and the
// cast to int32
__device__ __forceinline__ int clamp_to_int(float v, float hi) {
  if (isnan(v)) return 0;
  return (int)fminf(fmaxf(v, 0.f), hi);
}

template <typename Index>
__global__ void __launch_bounds__(kSetupThreads) setup_bin(
    const float* __restrict__ verts, long long nv, const Index* __restrict__ faces, int nf,
    int h, int w, int ntx, int cap, float* __restrict__ recs, int4* __restrict__ bbox,
    int* __restrict__ tile_count, int* __restrict__ tile_list, int* __restrict__ wide,
    int* __restrict__ wide_count) {
  // no thread leaves before the warp-wide binning below
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = f < nf;
  float sx[3], sy[3], sz[3];
  bool in_range = live;
  const float wm1 = (float)(w - 1), hm1 = (float)(h - 1);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const long long vi = live ? (long long)faces[3 * (size_t)f + j] : -1;
    float4 v = make_float4(0.f, 0.f, 0.f, 1.f);  // an index out of range culls the face
    if (vi >= 0 && vi < nv) {
      const float* p = verts + 4 * (size_t)vi;
      v = make_float4(p[0], p[1], p[2], p[3]);
    } else {
      in_range = false;
    }
    const float vw = v.w == 0.f ? 1e-8f : v.w;
    sx[j] = __fmul_rn(__fadd_rn(__fmul_rn(__fdiv_rn(v.x, vw), 0.5f), 0.5f), wm1);
    sy[j] = __fmul_rn(__fsub_rn(0.5f, __fmul_rn(__fdiv_rn(v.y, vw), 0.5f)), hm1);
    sz[j] = __fadd_rn(__fmul_rn(__fdiv_rn(v.z, vw), 0.5f), 0.5f);
  }
  const float area =
      __fsub_rn(__fmul_rn(__fsub_rn(sx[1], sx[0]), __fsub_rn(sy[2], sy[0])),
                __fmul_rn(__fsub_rn(sx[2], sx[0]), __fsub_rn(sy[1], sy[0])));
  bool valid = in_range && fabsf(area) >= 1e-12f;  // false for a NaN area
  const float inv = valid ? __fdiv_rn(1.f, area) : 0.f;
  const float rec[kRec] = {
      __fmul_rn(__fsub_rn(sy[1], sy[2]), inv),
      __fmul_rn(__fsub_rn(sx[2], sx[1]), inv),
      __fmul_rn(__fsub_rn(__fmul_rn(sx[1], sy[2]), __fmul_rn(sx[2], sy[1])), inv),
      __fmul_rn(__fsub_rn(sy[2], sy[0]), inv),
      __fmul_rn(__fsub_rn(sx[0], sx[2]), inv),
      __fmul_rn(__fsub_rn(__fmul_rn(sx[2], sy[0]), __fmul_rn(sx[0], sy[2])), inv),
      __fsub_rn(sz[0], sz[2]),
      __fsub_rn(sz[1], sz[2]),
      sz[2]};
  const float smin = min3(sx[0], sx[1], sx[2]), smax = max3(sx[0], sx[1], sx[2]);
  const float tmin = min3(sy[0], sy[1], sy[2]), tmax = max3(sy[0], sy[1], sy[2]);
  const bool offscreen = smax < 0.f || smin > wm1 || tmax < 0.f || tmin > hm1;
  valid = valid && !offscreen;
  int4 b;
  b.x = valid ? clamp_to_int(floorf(smin), wm1) : 0;
  b.y = valid ? clamp_to_int(ceilf(smax), wm1) : -1;
  b.z = clamp_to_int(floorf(tmin), hm1);
  b.w = clamp_to_int(ceilf(tmax), hm1);
  if (live) {
#pragma unroll
    for (int j = 0; j < kRec; ++j) recs[(size_t)f * kRec + j] = rec[j];
    bbox[f] = b;
  }
  // binning, all 32 lanes in step: the k-th tile of each lane's face, the
  // lanes on one tile take their slots with one atomicAdd (neighbouring
  // faces of a mesh tend to share tiles)
  const int tx0 = b.x / kTile, ty0 = b.z / kTile;
  const int fw = valid ? b.y / kTile - tx0 + 1 : 0, fh = valid ? b.w / kTile - ty0 + 1 : 0;
  bool to_wide = valid && (long long)fw * fh > kMaxTiles;
  const int ntile = valid && !to_wide ? fw * fh : 0;
  const unsigned lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kMaxTiles; ++k) {
    const int t = k < ntile ? (ty0 + k / fw) * ntx + tx0 + k % fw : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, t);
    if (t >= 0) {
      const int leader = __ffs(peers) - 1;
      int slot = 0;
      if ((int)lane == leader) slot = atomicAdd(tile_count + t, __popc(peers));
      slot = __shfl_sync(peers, slot, leader) + __popc(peers & ((1u << lane) - 1));
      if (slot < cap)
        tile_list[(size_t)t * cap + slot] = f;
      else
        to_wide = true;  // the wide list covers this tile (and the others again)
    }
  }
  if (to_wide) wide[atomicAdd(wide_count, 1)] = f;
}


// One (face, pixel) test into the tile's tokens: the TPU kernel's coverage
// and depth arithmetic, then a 64-bit shared atomicMin after a plain read
// that skips occluded pixels (a stale read is only ever too large).
__device__ __forceinline__ void cover(const float* r, int face, int x, int y, int X0, int Y0,
                                      unsigned long long* tok) {
  const float px = (float)x, py = (float)y;
  const float w0 = edge(r[0], r[1], r[2], px, py);
  const float w1 = edge(r[3], r[4], r[5], px, py);
  const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
  if (!(w0 >= 0.f && w1 >= 0.f && w2 >= 0.f)) return;
  float z = __fadd_rn(__fadd_rn(r[8], __fmul_rn(w0, r[6])), __fmul_rn(w1, r[7]));
  if (z <= 0.f) z = 0.f;  // also folds -0 to +0
  if (z > 1.f) z = 1.f;
  if (!(z < 2.f)) return;  // NaN depth never covers (the TPU sweep's z < best)
  const unsigned long long token =
      ((unsigned long long)__float_as_uint(z) << 32) | (unsigned int)face;
  const int s = (y - Y0) * kTile + (x - X0);
  if (token < ((volatile unsigned long long*)tok)[s]) atomicMin(tok + s, token);
}

__global__ void __launch_bounds__(kTileThreads) raster_tiles(
    const float* __restrict__ recs, const int4* __restrict__ bbox, int h, int w, int ntx,
    int cap, const int* __restrict__ tile_count, const int* __restrict__ tile_list,
    const int* __restrict__ wide, const int* __restrict__ wide_count, int* __restrict__ face_id,
    float* __restrict__ bary, float* __restrict__ depth) {
  __shared__ unsigned long long tok[kTile * kTile];
  // this round's faces: records, id, clipped bbox origin and width, and the
  // inclusive prefix sum of their (face, pixel) pair counts
  __shared__ float s_rec[kTileThreads * kRec];
  __shared__ int s_face[kTileThreads], s_x0[kTileThreads], s_y0[kTileThreads];
  __shared__ int s_bw[kTileThreads], s_end[kTileThreads], s_warp[kWarps];
  const int t = blockIdx.x;
  const int X0 = (t % ntx) * kTile, Y0 = (t / ntx) * kTile;
  const int X1 = min(X0 + kTile, w) - 1, Y1 = min(Y0 + kTile, h) - 1;
  for (int p = threadIdx.x; p < kTile * kTile; p += kTileThreads) tok[p] = kEmpty;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_list = min(tile_count[t], cap);
  const int n_items = n_list + *wide_count;
  const int* list = tile_list + (size_t)t * cap;
  // Rounds of kTileThreads faces (the tile's list, then the wide list): a
  // thread loads a face and its pair count, a block scan lays the round's
  // pairs end to end, and every thread takes an equal run of them, so a
  // tile of many small faces and one of a few large ones keep all lanes
  // busy alike.
  for (int base = 0; base < n_items; base += kTileThreads) {
    const int i = base + tid;
    int n = 0;
    if (i < n_items) {
      const int f = i < n_list ? list[i] : wide[i - n_list];
      const int4 b = bbox[f];
      const int cx0 = max(b.x, X0), cx1 = min(b.y, X1);
      const int cy0 = max(b.z, Y0), cy1 = min(b.w, Y1);
      if (cx0 <= cx1 && cy0 <= cy1) {  // else a wide face off this tile
        n = (cx1 - cx0 + 1) * (cy1 - cy0 + 1);
        s_face[tid] = f;
        s_x0[tid] = cx0;
        s_y0[tid] = cy0;
        s_bw[tid] = cx1 - cx0 + 1;
#pragma unroll
        for (int j = 0; j < kRec; ++j) s_rec[tid * kRec + j] = recs[(size_t)f * kRec + j];
      }
    }
    int v = n;  // inclusive scan: within the warp, then over the warps' sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int s = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += u;
      }
      if (lane < kWarps) s_warp[lane] = s;
    }
    __syncthreads();
    s_end[tid] = v + (warp > 0 ? s_warp[warp - 1] : 0);
    const int total = s_warp[kWarps - 1];
    __syncthreads();
    // thread tid takes the pairs [tid * per, (tid + 1) * per): one binary
    // search for its first face, then pixel after pixel, face after face
    const int per = (total + kTileThreads - 1) / kTileThreads;
    int j = tid * per;
    const int j_end = min(j + per, total);
    if (j < j_end) {
      int k = 0, hi = kTileThreads - 1;  // the first face whose pairs end after j
      while (k < hi) {
        const int mid = (k + hi) >> 1;
        if (s_end[mid] > j) hi = mid; else k = mid + 1;
      }
      const int p = j - (k > 0 ? s_end[k - 1] : 0);
      int x = s_x0[k] + p % s_bw[k], y = s_y0[k] + p / s_bw[k];
      for (;;) {
        cover(s_rec + k * kRec, s_face[k], x, y, X0, Y0, tok);
        if (++j == j_end) break;
        if (j == s_end[k]) {  // the next face with pairs
          while (s_end[k] <= j) ++k;
          x = s_x0[k];
          y = s_y0[k];
        } else if (++x == s_x0[k] + s_bw[k]) {
          x = s_x0[k];
          ++y;
        }
      }
    }
    __syncthreads();  // the round's arrays are read before the next round writes them
  }
  __syncthreads();

  // resolve: a warp per tile row, coalesced stores
  for (int p = threadIdx.x; p < kTile * kTile; p += kTileThreads) {
    const int x = X0 + (p & (kTile - 1)), y = Y0 + p / kTile;
    if (x > X1 || y > Y1) continue;
    const size_t o = (size_t)y * w + x;
    const unsigned long long token = tok[p];
    if (token == kEmpty) {
      face_id[o] = -1;
      depth[o] = 0.f;
      bary[3 * o] = bary[3 * o + 1] = bary[3 * o + 2] = 0.f;
      continue;
    }
    const int f = (int)(token & 0xffffffffu);
    const float* r = recs + (size_t)f * kRec;
    const float px = (float)x, py = (float)y;
    const float w0 = edge(r[0], r[1], r[2], px, py);
    const float w1 = edge(r[3], r[4], r[5], px, py);
    face_id[o] = f;
    depth[o] = __uint_as_float((unsigned int)(token >> 32));
    bary[3 * o] = w0;
    bary[3 * o + 1] = w1;
    bary[3 * o + 2] = __fsub_rn(__fsub_rn(1.f, w0), w1);
  }
}

}  // namespace

// verts [nv, 4] float32 clip space and faces [nf, 3] (int32, or int64 when
// faces64) on the device. Workspace, from the wrapper: recs [nf, 9] float32
// and bbox [nf, 4] int32 (written here: the records and x0 x1 y0 y1 of
// ops/rasterize.py face_setup, x0 > x1 for a culled face), counts
// [ntiles + 3] int32 (cleared here: the tile counts, the wide count and two
// zeros the wrapper returns as the overflow), tile_list [ntiles * cap],
// wide [max(nf, 1)] int32, with ntiles = ceil(h/32) * ceil(w/32). Writes
// face_id [h*w] int32, bary [h*w, 3] float32, depth [h*w] float32. One
// memset and two launches in order on `stream`; returns the first
// cudaError_t (0 on success).
extern "C" int hy3d_rasterize(const float* verts, long long nv, const void* faces, int faces64,
                              int nf, int h, int w, int cap, float* recs, int* bbox, int* counts,
                              int* tile_list, int* wide, int* face_id, float* bary,
                              float* depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nf < 0 || h <= 0 || w <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const int ntx = (w + kTile - 1) / kTile, nty = (h + kTile - 1) / kTile;
  const long long ntiles = (long long)ntx * nty;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)(ntiles + 3), s);
  if (err != cudaSuccess) return (int)err;
  int4* bb = reinterpret_cast<int4*>(bbox);
  int* wide_count = counts + ntiles;
  if (nf > 0) {
    const int blocks = (nf + kSetupThreads - 1) / kSetupThreads;
    if (faces64)
      setup_bin<long long><<<blocks, kSetupThreads, 0, s>>>(
          verts, nv, static_cast<const long long*>(faces), nf, h, w, ntx, cap, recs, bb,
          counts, tile_list, wide, wide_count);
    else
      setup_bin<int><<<blocks, kSetupThreads, 0, s>>>(
          verts, nv, static_cast<const int*>(faces), nf, h, w, ntx, cap, recs, bb, counts,
          tile_list, wide, wide_count);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  raster_tiles<<<(unsigned int)ntiles, kTileThreads, 0, s>>>(recs, bb, h, w, ntx, cap, counts,
                                                             tile_list, wide, wide_count,
                                                             face_id, bary, depth);
  return (int)cudaGetLastError();
}
