// hy3dnative — native CPU runtime components, the part of
// hunyuan3d2_tpu/native/hy3dnative.cpp that the PyTorch port binds (the port
// imports nothing of the JAX package). One change: hy3d_grid_put_linear
// hands its scratch to the OpenMP workers through plain pointers (see there).
//
// Kept here:
//   * z-buffer triangle rasterization with a deterministic packed
//     depth|face-id resolve (the UV unwrap's chart overlap guard, the host
//     renders), and the same raster fused with attribute interpolation,
//   * mesh_processor vertex-graph texture inpainting and the push-pull
//     hole fill (the texture inpaint),
//   * the host bake: the bilinear splat (back_project) and the fused
//     per-view bake, from a full-size float view or a native-size uint8 one
//     (both serial: their thread_local scratch is never read inside an
//     OpenMP region),
//   * connected-component face labelling, quadric edge-collapse
//     simplification, the exact vertex weld with degenerate/duplicate face
//     removal, and uniform vertex-cluster decimation (the mesh postprocess;
//     all four serial),
//   * surface nets over a dense grid and from compacted active cells (the
//     'dmc'/'sn' extractor's host passes).
//
// C ABI for ctypes binding. Parallel loops use OpenMP with deterministic
// reductions.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Rasterization
// ---------------------------------------------------------------------------
// verts_ndc: [nv,4] clip-space positions (x,y in [-1,1] after divide, z depth,
// w for perspective). faces: [nf,3]. Output:
//   face_id:  [h,w] int32, -1 where empty, else face index
//   bary:     [h,w,3] float32 perspective-corrected barycentrics
//   depth:    [h,w] float32
// Deterministic: nearest depth wins; ties broken by lowest face id (the
// packed uint64 compare gives exactly that ordering).
void hy3d_rasterize(const float* verts, int64_t nv, const int32_t* faces,
                    int64_t nf, int h, int w, int32_t* face_id, float* bary,
                    float* depth) {
  (void)nv;
  std::vector<std::atomic<uint64_t>> zbuf(static_cast<size_t>(h) * w);
  const uint64_t EMPTY = ~0ull;
  for (auto& z : zbuf) z.store(EMPTY, std::memory_order_relaxed);

#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t f = 0; f < nf; ++f) {
    const int32_t* tri = faces + 3 * f;
    float sx[3], sy[3], sz[3], sw[3];
    for (int k = 0; k < 3; ++k) {
      const float* v = verts + 4 * tri[k];
      float vw = v[3] == 0.f ? 1e-8f : v[3];
      sx[k] = (v[0] / vw * 0.5f + 0.5f) * (w - 1);
      sy[k] = (0.5f - v[1] / vw * 0.5f) * (h - 1);
      // OpenGL-style NDC depth is in [-1,1] (ortho/persp projections map
      // near→-1); remap to [0,1] BEFORE the clamp below, otherwise every
      // camera-facing surface clamps to 0 and the z-test degenerates to
      // lowest-face-id-wins (the reference kernel survives negative z via
      // unsigned wraparound that stays monotone, rasterizer.cpp:30-33).
      sz[k] = v[2] / vw * 0.5f + 0.5f;
      sw[k] = vw;
    }
    float area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sx[2] - sx[0]) * (sy[1] - sy[0]);
    if (std::fabs(area) < 1e-12f) continue;
    int x0 = std::max(0, (int)std::floor(std::min({sx[0], sx[1], sx[2]})));
    int x1 = std::min(w - 1, (int)std::ceil(std::max({sx[0], sx[1], sx[2]})));
    int y0 = std::max(0, (int)std::floor(std::min({sy[0], sy[1], sy[2]})));
    int y1 = std::min(h - 1, (int)std::ceil(std::max({sy[0], sy[1], sy[2]})));
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        float px = (float)x, py = (float)y;
        float w0 = ((sx[1] - px) * (sy[2] - py) - (sx[2] - px) * (sy[1] - py)) / area;
        float w1 = ((sx[2] - px) * (sy[0] - py) - (sx[0] - px) * (sy[2] - py)) / area;
        float w2 = 1.f - w0 - w1;
        if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
        float z = w0 * sz[0] + w1 * sz[1] + w2 * sz[2];
        if (z < 0.f) z = 0.f;
        if (z > 1.f) z = 1.f;
        // pack depth (high bits) | face id (low bits): min == nearest, tie →
        // lowest face id. Deterministic under concurrent updates.
        uint64_t key = ((uint64_t)(z * 4294967295.0f) << 32) | (uint32_t)f;
        std::atomic<uint64_t>& cell = zbuf[(size_t)y * w + x];
        uint64_t cur = cell.load(std::memory_order_relaxed);
        while (key < cur &&
               !cell.compare_exchange_weak(cur, key, std::memory_order_relaxed)) {
        }
      }
    }
  }

  // second pass: recover barycentrics (perspective-corrected)
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < (int64_t)h * w; ++p) {
    uint64_t key = zbuf[p].load(std::memory_order_relaxed);
    if (key == EMPTY) {
      face_id[p] = -1;
      depth[p] = 0.f;
      bary[3 * p] = bary[3 * p + 1] = bary[3 * p + 2] = 0.f;
      continue;
    }
    int32_t f = (int32_t)(key & 0xffffffffu);
    face_id[p] = f;
    depth[p] = (float)(key >> 32) / 4294967295.0f;
    const int32_t* tri = faces + 3 * f;
    int x = (int)(p % w), y = (int)(p / w);
    float sx[3], sy[3], sw[3];
    for (int k = 0; k < 3; ++k) {
      const float* v = verts + 4 * tri[k];
      float vw = v[3] == 0.f ? 1e-8f : v[3];
      sx[k] = (v[0] / vw * 0.5f + 0.5f) * (w - 1);
      sy[k] = (0.5f - v[1] / vw * 0.5f) * (h - 1);
      sw[k] = vw;
    }
    float area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sx[2] - sx[0]) * (sy[1] - sy[0]);
    float px = (float)x, py = (float)y;
    float w0 = ((sx[1] - px) * (sy[2] - py) - (sx[2] - px) * (sy[1] - py)) / area;
    float w1 = ((sx[2] - px) * (sy[0] - py) - (sx[0] - px) * (sy[2] - py)) / area;
    float w2 = 1.f - w0 - w1;
    // perspective correction: weights / w, renormalized
    float iw0 = w0 / sw[0], iw1 = w1 / sw[1], iw2 = w2 / sw[2];
    float s = iw0 + iw1 + iw2;
    if (s != 0.f) {
      iw0 /= s;
      iw1 /= s;
      iw2 /= s;
    }
    bary[3 * p] = iw0;
    bary[3 * p + 1] = iw1;
    bary[3 * p + 2] = iw2;
  }
}

// Rasterize + interpolate per-vertex attributes in one fused pass:
// attrs [nv, C] → out_attr [h, w, C] (0 where empty). Shares the z-resolve
// with hy3d_rasterize; avoids the big numpy gather temporaries on the host.
void hy3d_rasterize_interp(const float* verts, int64_t nv, const int32_t* faces,
                           int64_t nf, const float* attrs, int c, int h, int w,
                           int32_t* face_id, float* bary, float* depth,
                           float* out_attr) {
  hy3d_rasterize(verts, nv, faces, nf, h, w, face_id, bary, depth);
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < (int64_t)h * w; ++p) {
    float* dst = out_attr + p * c;
    int32_t f = face_id[p];
    if (f < 0) {
      for (int ch = 0; ch < c; ++ch) dst[ch] = 0.f;
      continue;
    }
    const int32_t* tri = faces + 3 * f;
    const float b0 = bary[3 * p], b1 = bary[3 * p + 1], b2 = bary[3 * p + 2];
    const float* a0 = attrs + (int64_t)tri[0] * c;
    const float* a1 = attrs + (int64_t)tri[1] * c;
    const float* a2 = attrs + (int64_t)tri[2] * c;
    for (int ch = 0; ch < c; ++ch)
      dst[ch] = b0 * a0[ch] + b1 * a1[ch] + b2 * a2[ch];
  }
}

// ---------------------------------------------------------------------------
// Vertex-graph texture inpainting (parity: mesh_processor.meshVerticeInpaint,
// differentiable_renderer/mesh_processor.cpp:12-156 behavior).
// ---------------------------------------------------------------------------
void hy3d_vertex_inpaint(const float* texture, const uint8_t* mask,
                         float* out_texture, uint8_t* out_mask, int th, int tw,
                         int tc, const float* vtx_pos, int64_t nv,
                         const float* vtx_uv, int64_t nuv, const int32_t* pos_idx,
                         const int32_t* uv_idx, int64_t nf) {
  (void)nuv;
  std::vector<float> vcolor((size_t)nv * tc, 0.f);
  std::vector<uint8_t> vmask(nv, 0);
  std::vector<std::vector<int32_t>> graph(nv);
  std::vector<int32_t> uncolored;
  uncolored.reserve(nv);

  auto texel = [&](int32_t uvi, int& u, int& v) {
    v = (int)std::lround(vtx_uv[2 * uvi] * (tw - 1));
    u = (int)std::lround((1.0f - vtx_uv[2 * uvi + 1]) * (th - 1));
    v = std::min(std::max(v, 0), tw - 1);
    u = std::min(std::max(u, 0), th - 1);
  };

  std::vector<uint8_t> seen(nv, 0);
  for (int64_t i = 0; i < nf; ++i) {
    for (int k = 0; k < 3; ++k) {
      int32_t vi = pos_idx[3 * i + k];
      int32_t ti = uv_idx[3 * i + k];
      int u, v;
      texel(ti, u, v);
      if (mask[(size_t)u * tw + v] > 0) {
        vmask[vi] = 1;
        for (int c = 0; c < tc; ++c)
          vcolor[(size_t)vi * tc + c] = texture[((size_t)u * tw + v) * tc + c];
      } else if (!seen[vi]) {
        uncolored.push_back(vi);
      }
      seen[vi] = 1;
      graph[vi].push_back(pos_idx[3 * i + (k + 1) % 3]);
    }
  }

  // BFS wavefront: each sweep colors exactly the uncolored vertices with a
  // colored neighbor (same level-order semantics as re-sweeping the whole
  // uncolored set, but O(E) total instead of O(sweeps·N) — large occluded
  // regions previously cost many full sweeps with a malloc per vertex)
  std::vector<int32_t> frontier = uncolored;
  std::vector<int32_t> next;
  float sum[16];
  const int tcc = std::min(tc, 16);
  while (!frontier.empty()) {
    next.clear();
    bool progress = false;
    for (int32_t vi : frontier) {
      if (vmask[vi] == 1) continue;
      float total_w = 0.f;
      for (int c = 0; c < tcc; ++c) sum[c] = 0.f;
      const float* p0 = vtx_pos + 3 * vi;
      for (int32_t nb : graph[vi]) {
        if (vmask[nb] != 1) continue;
        const float* p1 = vtx_pos + 3 * nb;
        float dx = p0[0] - p1[0], dy = p0[1] - p1[1], dz = p0[2] - p1[2];
        float dist = std::sqrt(dx * dx + dy * dy + dz * dz);
        float wgt = 1.f / std::max(dist, 1e-4f);
        wgt *= wgt;
        for (int c = 0; c < tcc; ++c)
          sum[c] += vcolor[(size_t)nb * tc + c] * wgt;
        total_w += wgt;
      }
      if (total_w > 0.f) {
        for (int c = 0; c < tcc; ++c)
          vcolor[(size_t)vi * tc + c] = sum[c] / total_w;
        vmask[vi] = 2;  // colored this sweep; activates next sweep
        progress = true;
      } else {
        next.push_back(vi);
      }
    }
    for (int32_t vi : frontier)
      if (vmask[vi] == 2) vmask[vi] = 1;
    if (!progress) break;
    frontier.swap(next);
  }

  std::memcpy(out_texture, texture, (size_t)th * tw * tc * sizeof(float));
  std::memcpy(out_mask, mask, (size_t)th * tw);
  for (int64_t i = 0; i < nf; ++i) {
    for (int k = 0; k < 3; ++k) {
      int32_t vi = pos_idx[3 * i + k];
      if (!vmask[vi]) continue;
      int u, v;
      texel(uv_idx[3 * i + k], u, v);
      for (int c = 0; c < tc; ++c)
        out_texture[((size_t)u * tw + v) * tc + c] = vcolor[(size_t)vi * tc + c];
      out_mask[(size_t)u * tw + v] = 255;
    }
  }
}

// Bilinear scatter-add of point samples into an [h,w,C] grid normalized by
// scattered weight (the texture-baking splat; numpy twin in geometry/
// render.py linear_grid_put_2d). coords [n,2] in [0,1] (x→rows, y→cols).
void hy3d_grid_put_linear(const float* coords, const float* values, int64_t n,
                          int h, int w, int c, float* out_grid) {
  // Reused across calls: first-touch page faults on this host are ~100 MB/s,
  // so re-allocating ~100 MB of scratch per view dominated the bake. Static
  // buffers grow once and stay warm (host render path is single-threaded).
  // The buffers are thread_local to the calling thread. The normalisation
  // loop below runs on OpenMP worker threads, which would each see their own
  // (empty) thread_local vectors, so it reads them through these pointers.
  thread_local static std::vector<float> acc_buf;
  thread_local static std::vector<float> cnt_buf;
  acc_buf.assign((size_t)h * w * c, 0.f);
  cnt_buf.assign((size_t)h * w, 0.f);
  float* const acc = acc_buf.data();
  float* const cnt = cnt_buf.data();
  for (int64_t i = 0; i < n; ++i) {
    float x = coords[2 * i] * (h - 1);
    float y = coords[2 * i + 1] * (w - 1);
    int x0 = std::min(std::max((int)std::floor(x), 0), h - 1);
    int y0 = std::min(std::max((int)std::floor(y), 0), w - 1);
    int x1 = std::min(x0 + 1, h - 1);
    int y1 = std::min(y0 + 1, w - 1);
    float fx = x - x0, fy = y - y0;
    const float wts[4] = {(1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy),
                          fx * fy};
    const int64_t idx[4] = {(int64_t)x0 * w + y0, (int64_t)x0 * w + y1,
                            (int64_t)x1 * w + y0, (int64_t)x1 * w + y1};
    const float* v = values + (int64_t)i * c;
    for (int k = 0; k < 4; ++k) {
      cnt[idx[k]] += wts[k];
      float* dst = acc + idx[k] * c;
      for (int ch = 0; ch < c; ++ch) dst[ch] += wts[k] * v[ch];
    }
  }
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < (int64_t)h * w; ++p) {
    float inv = cnt[p] > 0.f ? 1.f / std::max(cnt[p], 1e-8f) : 0.f;
    for (int ch = 0; ch < c; ++ch) out_grid[p * c + ch] = acc[p * c + ch] * inv;
  }
}

// Fused per-view texture bake: applies the reliability/cosine masks, splats
// [image | cos] bilinearly into per-view accumulators, normalizes, and merges
// into the running texture with the reference's >99%-painted skip — one pass,
// no intermediate full-res arrays (numerically identical to back_project →
// fast_bake_texture, reference mesh_render.py:653-798).
//   amap:     [h,w,6] (nx,ny,nz, u,v, depth) from hy3d_rasterize_interp
//   fid:      [h,w] face ids (<0 = background)
//   image:    [h,w,c] view colors
//   reliable: [h,w] uint8 (visibility-eroded & not near a depth edge)
//   tex_merge:[th,tw,c] running weighted sum; trust: [th,tw] running weight
// Returns 1 if the view was merged, 0 if skipped (>99% already painted).
int hy3d_bake_view(const float* amap, const int32_t* fid, const float* image,
                   const uint8_t* reliable, float cos_thres, int h, int w,
                   int c, int th, int tw, float weight, float expnt,
                   float* tex_merge, float* trust) {
  thread_local static std::vector<float> acc;  // [th*tw*(c+1)] color|cos
  thread_local static std::vector<float> cnt;  // [th*tw] bilinear weights
  const int cc = c + 1;
  acc.assign((size_t)th * tw * cc, 0.f);
  cnt.assign((size_t)th * tw, 0.f);
  for (int64_t p = 0; p < (int64_t)h * w; ++p) {
    if (!reliable[p] || fid[p] < 0) continue;
    const float* a = amap + p * 6;
    float cosang = -a[2];
    if (cosang < cos_thres) cosang = 0.f;
    // row = v, col = u (back_project coords = uv[:, [1,0]])
    float x = a[4] * (th - 1);
    float y = a[3] * (tw - 1);
    int x0 = std::min(std::max((int)std::floor(x), 0), th - 1);
    int y0 = std::min(std::max((int)std::floor(y), 0), tw - 1);
    int x1 = std::min(x0 + 1, th - 1);
    int y1 = std::min(y0 + 1, tw - 1);
    float fx = x - x0, fy = y - y0;
    const float wts[4] = {(1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy),
                          fx * fy};
    const int64_t idx[4] = {(int64_t)x0 * tw + y0, (int64_t)x0 * tw + y1,
                            (int64_t)x1 * tw + y0, (int64_t)x1 * tw + y1};
    const float* col = image + p * c;
    for (int k = 0; k < 4; ++k) {
      cnt[idx[k]] += wts[k];
      float* dst = acc.data() + idx[k] * cc;
      for (int ch = 0; ch < c; ++ch) dst[ch] += wts[k] * col[ch];
      dst[c] += wts[k] * cosang;
    }
  }
  // skip check: fraction of this view's positive-cos texels already painted
  int64_t view_sum = 0, painted = 0;
  for (int64_t t = 0; t < (int64_t)th * tw; ++t) {
    if (cnt[t] <= 0.f) continue;
    float cosm = acc[t * cc + c] / std::max(cnt[t], 1e-8f);
    if (cosm > 0.f) {
      ++view_sum;
      if (trust[t] > 0.f) ++painted;
    }
  }
  if (view_sum > 0 && (double)painted / (double)view_sum > 0.99) return 0;
  for (int64_t t = 0; t < (int64_t)th * tw; ++t) {
    if (cnt[t] <= 0.f) continue;
    float inv = 1.f / std::max(cnt[t], 1e-8f);
    float cosm = acc[t * cc + c] * inv;
    float cw = weight * std::pow(cosm, expnt);
    if (!(cw > 0.f)) continue;
    float* dst = tex_merge + t * c;
    for (int ch = 0; ch < c; ++ch) dst[ch] += acc[t * cc + ch] * inv * cw;
    trust[t] += cw;
  }
  return 1;
}

// hy3d_bake_view with the view image kept at its NATIVE resolution as uint8:
// the diffusion views are 512² while the bake raster is 2048², and the
// reference upsamples the view before splatting (texgen pipelines.py:237).
// Upsampling is color-interpolation only, so instead of materializing a
// 50 MB fp32 2048² image per view (its first-touch page faults would dominate)
// this kernel bilinearly samples the uint8 view at the raster pixel's
// position (align_corners=False convention, matching a PIL BILINEAR
// upsample) inside the splat loop. image: [ih,iw,c] uint8.
int hy3d_bake_view_u8(const float* amap, const int32_t* fid,
                      const uint8_t* image, int ih, int iw,
                      const uint8_t* reliable, float cos_thres, int h, int w,
                      int c, int th, int tw, float weight, float expnt,
                      float* tex_merge, float* trust) {
  if (c > 8) return -1;  // fixed col[8] below; Python wrapper raises
  thread_local static std::vector<float> acc;  // [th*tw*(c+1)] color|cos
  thread_local static std::vector<float> cnt;  // [th*tw] bilinear weights
  const int cc = c + 1;
  acc.assign((size_t)th * tw * cc, 0.f);
  cnt.assign((size_t)th * tw, 0.f);
  const float sx = (float)ih / (float)h, sy = (float)iw / (float)w;
  const float inv255 = 1.f / 255.f;
  for (int64_t p = 0; p < (int64_t)h * w; ++p) {
    if (!reliable[p] || fid[p] < 0) continue;
    const float* a = amap + p * 6;
    float cosang = -a[2];
    if (cosang < cos_thres) cosang = 0.f;
    // sample the native-size view at this raster pixel's center
    const int pr = (int)(p / w), pc2 = (int)(p % w);
    float ix = (pr + 0.5f) * sx - 0.5f;
    float iy = (pc2 + 0.5f) * sy - 0.5f;
    int ix0 = std::min(std::max((int)std::floor(ix), 0), ih - 1);
    int iy0 = std::min(std::max((int)std::floor(iy), 0), iw - 1);
    int ix1 = std::min(ix0 + 1, ih - 1);
    int iy1 = std::min(iy0 + 1, iw - 1);
    float gx = std::min(std::max(ix - ix0, 0.f), 1.f);
    float gy = std::min(std::max(iy - iy0, 0.f), 1.f);
    const uint8_t* r0 = image + ((int64_t)ix0 * iw + iy0) * c;
    const uint8_t* r1 = image + ((int64_t)ix0 * iw + iy1) * c;
    const uint8_t* r2 = image + ((int64_t)ix1 * iw + iy0) * c;
    const uint8_t* r3 = image + ((int64_t)ix1 * iw + iy1) * c;
    const float w0 = (1 - gx) * (1 - gy), w1 = (1 - gx) * gy,
                w2 = gx * (1 - gy), w3 = gx * gy;
    float col[8];
    for (int ch = 0; ch < c; ++ch)
      col[ch] = (w0 * r0[ch] + w1 * r1[ch] + w2 * r2[ch] + w3 * r3[ch]) *
                inv255;
    // row = v, col = u (back_project coords = uv[:, [1,0]])
    float x = a[4] * (th - 1);
    float y = a[3] * (tw - 1);
    int x0 = std::min(std::max((int)std::floor(x), 0), th - 1);
    int y0 = std::min(std::max((int)std::floor(y), 0), tw - 1);
    int x1 = std::min(x0 + 1, th - 1);
    int y1 = std::min(y0 + 1, tw - 1);
    float fx = x - x0, fy = y - y0;
    const float wts[4] = {(1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy),
                          fx * fy};
    const int64_t idx[4] = {(int64_t)x0 * tw + y0, (int64_t)x0 * tw + y1,
                            (int64_t)x1 * tw + y0, (int64_t)x1 * tw + y1};
    for (int k = 0; k < 4; ++k) {
      cnt[idx[k]] += wts[k];
      float* dst = acc.data() + idx[k] * cc;
      for (int ch = 0; ch < c; ++ch) dst[ch] += wts[k] * col[ch];
      dst[c] += wts[k] * cosang;
    }
  }
  // skip check: fraction of this view's positive-cos texels already painted
  int64_t view_sum = 0, painted = 0;
  for (int64_t t = 0; t < (int64_t)th * tw; ++t) {
    if (cnt[t] <= 0.f) continue;
    float cosm = acc[t * cc + c] / std::max(cnt[t], 1e-8f);
    if (cosm > 0.f) {
      ++view_sum;
      if (trust[t] > 0.f) ++painted;
    }
  }
  if (view_sum > 0 && (double)painted / (double)view_sum > 0.99) return 0;
  for (int64_t t = 0; t < (int64_t)th * tw; ++t) {
    if (cnt[t] <= 0.f) continue;
    float inv = 1.f / std::max(cnt[t], 1e-8f);
    float cosm = acc[t * cc + c] * inv;
    float cw = weight * std::pow(cosm, expnt);
    if (!(cw > 0.f)) continue;
    float* dst = tex_merge + t * c;
    for (int ch = 0; ch < c; ++ch) dst[ch] += acc[t * cc + ch] * inv * cw;
    trust[t] += cw;
  }
  return 1;
}

// Push-pull pyramid hole fill: build a valid-weighted mip pyramid (push),
// then fill unknown texels from coarser levels (pull). O(N) replacement for
// the slow diffusion inpaint on large texture atlases; texels under the mask
// keep their exact values.
//   texture: [h,w,c] fp32 in/out; mask: [h,w] uint8 (255 = known)
void hy3d_pushpull_fill(float* texture, const uint8_t* mask, int h, int w,
                        int c) {
  // level 0 buffers: color premultiplied by weight
  std::vector<std::vector<float>> lv_col;
  std::vector<std::vector<float>> lv_wgt;
  std::vector<int> lh{h}, lw{w};
  lv_col.emplace_back((size_t)h * w * c);
  lv_wgt.emplace_back((size_t)h * w);
  {
    auto& col = lv_col[0];
    auto& wgt = lv_wgt[0];
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < (int64_t)h * w; ++p) {
      float m = mask[p] ? 1.f : 0.f;
      wgt[p] = m;
      for (int ch = 0; ch < c; ++ch) col[p * c + ch] = texture[p * c + ch] * m;
    }
  }
  // push: 2x downsample of premultiplied color + weight
  while (lh.back() > 1 || lw.back() > 1) {
    int ph = lh.back(), pw = lw.back();
    int nh = std::max(1, ph / 2), nw = std::max(1, pw / 2);
    lv_col.emplace_back((size_t)nh * nw * c, 0.f);
    lv_wgt.emplace_back((size_t)nh * nw, 0.f);
    auto& pc = lv_col[lv_col.size() - 2];
    auto& pwt = lv_wgt[lv_wgt.size() - 2];
    auto& ncl = lv_col.back();
    auto& nwt = lv_wgt.back();
    for (int y = 0; y < nh; ++y)
      for (int x = 0; x < nw; ++x) {
        for (int dy = 0; dy < 2; ++dy)
          for (int dx = 0; dx < 2; ++dx) {
            int sy = std::min(2 * y + dy, ph - 1), sx = std::min(2 * x + dx, pw - 1);
            nwt[(size_t)y * nw + x] += pwt[(size_t)sy * pw + sx];
            for (int ch = 0; ch < c; ++ch)
              ncl[((size_t)y * nw + x) * c + ch] +=
                  pc[((size_t)sy * pw + sx) * c + ch];
          }
      }
    lh.push_back(nh);
    lw.push_back(nw);
    if (nh == 1 && nw == 1) break;
  }
  // pull: fill unknowns from the parent level (bilinear-ish nearest parent)
  for (int l = (int)lh.size() - 2; l >= 0; --l) {
    int ph = lh[l + 1], pw = lw[l + 1];
    int ch_ = lh[l], cw = lw[l];
    auto& par_c = lv_col[l + 1];
    auto& par_w = lv_wgt[l + 1];
    auto& cur_c = lv_col[l];
    auto& cur_w = lv_wgt[l];
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < (int64_t)ch_ * cw; ++p) {
      if (cur_w[p] > 0.f) continue;
      int y = (int)(p / cw), x = (int)(p % cw);
      int sy = std::min(y / 2, ph - 1), sx = std::min(x / 2, pw - 1);
      float wgt = par_w[(size_t)sy * pw + sx];
      if (wgt <= 0.f) continue;
      for (int chn = 0; chn < c; ++chn)
        cur_c[p * c + chn] = par_c[((size_t)sy * pw + sx) * c + chn] / wgt;
      cur_w[p] = 1.f;
    }
  }
  // write back only unknown texels (normalize premultiplied values)
  auto& col = lv_col[0];
  auto& wgt = lv_wgt[0];
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < (int64_t)h * w; ++p) {
    if (mask[p]) continue;
    float iw = wgt[p] > 0.f ? 1.f : 0.f;
    for (int chn = 0; chn < c; ++chn)
      texture[p * c + chn] = col[p * c + chn] * iw;
  }
}

// ---------------------------------------------------------------------------
// Connected components over the face graph (shared-vertex adjacency).
// labels: [nf] int32 component id; returns number of components.
// ---------------------------------------------------------------------------
int32_t hy3d_face_components(const int32_t* faces, int64_t nf, int64_t nv,
                             int32_t* labels) {
  std::vector<int32_t> parent(nv);
  for (int64_t i = 0; i < nv; ++i) parent[i] = (int32_t)i;
  std::function<int32_t(int32_t)> find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int64_t f = 0; f < nf; ++f) {
    int32_t a = find(faces[3 * f]), b = find(faces[3 * f + 1]),
            c = find(faces[3 * f + 2]);
    parent[b] = a;
    parent[find(c)] = find(a);
  }
  std::vector<int32_t> remap(nv, -1);
  int32_t n_comp = 0;
  for (int64_t f = 0; f < nf; ++f) {
    int32_t r = find(faces[3 * f]);
    if (remap[r] < 0) remap[r] = n_comp++;
    labels[f] = remap[r];
  }
  return n_comp;
}

// ---------------------------------------------------------------------------
// Quadric edge-collapse simplification (Garland–Heckbert).
// ---------------------------------------------------------------------------
namespace {
struct Quadric {
  double m[10] = {0};  // symmetric 4x4: xx xy xz xw yy yz yw zz zw ww
  void add_plane(double a, double b, double c, double d, double w) {
    m[0] += w * a * a;
    m[1] += w * a * b;
    m[2] += w * a * c;
    m[3] += w * a * d;
    m[4] += w * b * b;
    m[5] += w * b * c;
    m[6] += w * b * d;
    m[7] += w * c * c;
    m[8] += w * c * d;
    m[9] += w * d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
  }
  double eval(double x, double y, double z) const {
    return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z + 2 * m[3] * x +
           m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y + m[7] * z * z +
           2 * m[8] * z + m[9];
  }
};

struct HeapEdge {
  double cost;
  int32_t a, b;
  uint32_t ver;
  bool operator<(const HeapEdge& o) const { return cost > o.cost; }
};
}  // namespace

void hy3d_simplify(const float* verts, int64_t nv, const int32_t* faces,
                   int64_t nf, int64_t target_faces, float* out_verts,
                   int64_t* out_nv, int32_t* out_faces, int64_t* out_nf) {
  std::vector<double> V(3 * nv);
  for (int64_t i = 0; i < 3 * nv; ++i) V[i] = verts[i];
  std::vector<int32_t> F(faces, faces + 3 * nf);
  std::vector<Quadric> Q(nv);
  std::vector<uint32_t> version(nv, 0);
  std::vector<int32_t> rep(nv);
  for (int64_t i = 0; i < nv; ++i) rep[i] = (int32_t)i;
  std::function<int32_t(int32_t)> find = [&](int32_t x) {
    while (rep[x] != x) {
      rep[x] = rep[rep[x]];
      x = rep[x];
    }
    return x;
  };

  std::vector<std::vector<int32_t>> vfaces(nv);
  auto face_plane = [&](int64_t f, double* abcd) -> bool {
    const double* p0 = &V[3 * F[3 * f]];
    const double* p1 = &V[3 * F[3 * f + 1]];
    const double* p2 = &V[3 * F[3 * f + 2]];
    double ux = p1[0] - p0[0], uy = p1[1] - p0[1], uz = p1[2] - p0[2];
    double vx = p2[0] - p0[0], vy = p2[1] - p0[1], vz = p2[2] - p0[2];
    double nx = uy * vz - uz * vy, ny = uz * vx - ux * vz, nz = ux * vy - uy * vx;
    double len = std::sqrt(nx * nx + ny * ny + nz * nz);
    if (len < 1e-20) return false;
    nx /= len;
    ny /= len;
    nz /= len;
    abcd[0] = nx;
    abcd[1] = ny;
    abcd[2] = nz;
    abcd[3] = -(nx * p0[0] + ny * p0[1] + nz * p0[2]);
    abcd[4] = len * 0.5;  // area weight
    return true;
  };

  for (int64_t f = 0; f < nf; ++f) {
    double pl[5];
    if (!face_plane(f, pl)) continue;
    for (int k = 0; k < 3; ++k) {
      Q[F[3 * f + k]].add_plane(pl[0], pl[1], pl[2], pl[3], pl[4]);
      vfaces[F[3 * f + k]].push_back((int32_t)f);
    }
  }

  auto edge_cost = [&](int32_t a, int32_t b, double* opt) {
    Quadric q = Q[a];
    q.add(Q[b]);
    // candidate positions: midpoint, a, b (skip the 4x4 solve for robustness)
    double cand[3][3] = {
        {(V[3 * a] + V[3 * b]) / 2, (V[3 * a + 1] + V[3 * b + 1]) / 2,
         (V[3 * a + 2] + V[3 * b + 2]) / 2},
        {V[3 * a], V[3 * a + 1], V[3 * a + 2]},
        {V[3 * b], V[3 * b + 1], V[3 * b + 2]}};
    double best = 1e300;
    for (auto& c : cand) {
      double e = q.eval(c[0], c[1], c[2]);
      if (e < best) {
        best = e;
        opt[0] = c[0];
        opt[1] = c[1];
        opt[2] = c[2];
      }
    }
    return best;
  };

  std::priority_queue<HeapEdge> heap;
  auto push_edges_of = [&](int32_t v) {
    int32_t rv = find(v);
    for (int32_t f : vfaces[rv]) {
      for (int k = 0; k < 3; ++k) {
        int32_t a = find(F[3 * f + k]), b = find(F[3 * f + (k + 1) % 3]);
        if (a == b) continue;
        if (a != rv && b != rv) continue;
        if (a > b) std::swap(a, b);
        double opt[3];
        double c = edge_cost(a, b, opt);
        heap.push({c, a, b, version[a] + version[b]});
      }
    }
  };
  // initial heap: each undirected edge exactly once (push_edges_of would
  // enqueue every edge up to 4× — 2 faces × 2 endpoint scans)
  {
    std::vector<int64_t> ekeys;
    ekeys.reserve(nf * 3);
    for (int64_t f = 0; f < nf; ++f)
      for (int k = 0; k < 3; ++k) {
        int32_t a = F[3 * f + k], b = F[3 * f + (k + 1) % 3];
        if (a == b) continue;
        if (a > b) std::swap(a, b);
        ekeys.push_back(((int64_t)a << 32) | (uint32_t)b);
      }
    std::sort(ekeys.begin(), ekeys.end());
    ekeys.erase(std::unique(ekeys.begin(), ekeys.end()), ekeys.end());
    for (int64_t key : ekeys) {
      int32_t a = (int32_t)(key >> 32), b = (int32_t)(key & 0xffffffff);
      double opt[3];
      double c = edge_cost(a, b, opt);
      heap.push({c, a, b, version[a] + version[b]});
    }
  }

  auto face_alive = [&](int64_t f) {
    int32_t a = find(F[3 * f]), b = find(F[3 * f + 1]), c = find(F[3 * f + 2]);
    return a != b && b != c && a != c;
  };
  // exact live-face tracking: a face can only die when one of its vertices
  // is merged, and every such face is in the merged list of the collapse —
  // no periodic full recount (the old 512-collapse rescan dominated runtime)
  std::vector<uint8_t> alive(nf, 0);
  int64_t live_faces = 0;
  for (int64_t f = 0; f < nf; ++f) {
    alive[f] = face_alive(f) ? 1 : 0;
    live_faces += alive[f];
  }

  while (live_faces > target_faces && !heap.empty()) {
    HeapEdge e = heap.top();
    heap.pop();
    int32_t a = find(e.a), b = find(e.b);
    if (a == b) continue;
    if (a > b) std::swap(a, b);
    if (version[a] + version[b] != e.ver || a != e.a || b != e.b) continue;

    // collapse b → a at optimal position
    double opt[3];
    edge_cost(a, b, opt);
    V[3 * a] = opt[0];
    V[3 * a + 1] = opt[1];
    V[3 * a + 2] = opt[2];
    Q[a].add(Q[b]);
    rep[b] = a;
    version[a]++;
    version[b]++;

    // merge face lists (dedup), retire newly-degenerate faces exactly
    auto& la = vfaces[a];
    auto& lb = vfaces[b];
    la.insert(la.end(), lb.begin(), lb.end());
    lb.clear();
    lb.shrink_to_fit();
    std::sort(la.begin(), la.end());
    la.erase(std::unique(la.begin(), la.end()), la.end());
    std::vector<int32_t> keep;
    keep.reserve(la.size());
    for (int32_t f : la) {
      if (!alive[f]) continue;
      if (!face_alive(f)) {
        alive[f] = 0;
        --live_faces;
        continue;
      }
      keep.push_back(f);
    }
    la = std::move(keep);
    push_edges_of(a);
  }

  // compact output
  std::vector<int32_t> vmap(nv, -1);
  int64_t onv = 0, onf = 0;
  for (int64_t f = 0; f < nf; ++f) {
    if (!face_alive(f)) continue;
    int32_t tri[3];
    for (int k = 0; k < 3; ++k) {
      int32_t v = find(F[3 * f + k]);
      if (vmap[v] < 0) {
        vmap[v] = (int32_t)onv;
        out_verts[3 * onv] = (float)V[3 * v];
        out_verts[3 * onv + 1] = (float)V[3 * v + 1];
        out_verts[3 * onv + 2] = (float)V[3 * v + 2];
        ++onv;
      }
      tri[k] = vmap[v];
    }
    out_faces[3 * onf] = tri[0];
    out_faces[3 * onf + 1] = tri[1];
    out_faces[3 * onf + 2] = tri[2];
    ++onf;
  }
  *out_nv = onv;
  *out_nf = onf;
}

// ---------------------------------------------------------------------------
// Exact vertex weld + degenerate/duplicate face removal in one hashing pass
// (the numpy twin — np.unique(axis=0) twice — lexsorts 500k-row arrays and
// dominated DegenerateFaceRemover). Open-addressing tables, no sort.
// ---------------------------------------------------------------------------
namespace {
struct OpenSet96 {
  // open-addressing set/map keyed by 3×uint32; value = insertion index
  std::vector<uint32_t> ka, kb, kc;
  std::vector<int32_t> val;
  size_t mask;
  explicit OpenSet96(size_t expect) {
    size_t cap = 16;
    while (cap < expect * 2) cap <<= 1;
    ka.assign(cap, 0xffffffffu);
    kb.assign(cap, 0);
    kc.assign(cap, 0);
    val.assign(cap, -1);
    mask = cap - 1;
  }
  static inline uint64_t mix(uint32_t a, uint32_t b, uint32_t c) {
    uint64_t h = (uint64_t)a * 0x9e3779b97f4a7c15ull;
    h ^= (uint64_t)b * 0xc2b2ae3d27d4eb4full;
    h ^= (uint64_t)c * 0x165667b19e3779f9ull;
    h ^= h >> 29;
    return h;
  }
  // returns existing value, or inserts fresh and returns it
  inline int32_t get_or_insert(uint32_t a, uint32_t b, uint32_t c,
                               int32_t fresh, bool* inserted) {
    size_t i = mix(a, b, c) & mask;
    for (;;) {
      if (val[i] < 0) {
        ka[i] = a;
        kb[i] = b;
        kc[i] = c;
        val[i] = fresh;
        *inserted = true;
        return fresh;
      }
      if (ka[i] == a && kb[i] == b && kc[i] == c) {
        *inserted = false;
        return val[i];
      }
      i = (i + 1) & mask;
    }
  }
};
}  // namespace

void hy3d_weld_dedup(const float* verts, int64_t nv, const int32_t* faces,
                     int64_t nf, float* out_verts, int64_t* out_nv,
                     int32_t* out_faces, int64_t* out_nf) {
  // weld by VALUE, not raw bit pattern: -0.0 must hash like +0.0 (meshes
  // straddling a coordinate axis produce both), matching the numpy
  // np.unique(axis=0) twin where -0.0 == 0.0 compare equal
  auto normbits = [](float v) -> uint32_t {
    v += 0.0f;  // -0.0f + 0.0f == +0.0f; other values unchanged
    uint32_t b;
    std::memcpy(&b, &v, sizeof(b));
    return b;
  };
  OpenSet96 weld((size_t)nv);
  std::vector<int32_t> remap(nv);
  int64_t onv = 0;
  for (int64_t i = 0; i < nv; ++i) {
    bool fresh;
    int32_t id = weld.get_or_insert(normbits(verts[3 * i]),
                                    normbits(verts[3 * i + 1]),
                                    normbits(verts[3 * i + 2]),
                                    (int32_t)onv, &fresh);
    if (fresh) {
      out_verts[3 * onv] = verts[3 * i];
      out_verts[3 * onv + 1] = verts[3 * i + 1];
      out_verts[3 * onv + 2] = verts[3 * i + 2];
      ++onv;
    }
    remap[i] = id;
  }
  OpenSet96 fset((size_t)nf);
  int64_t onf = 0;
  for (int64_t f = 0; f < nf; ++f) {
    int32_t a = remap[faces[3 * f]], b = remap[faces[3 * f + 1]],
            c = remap[faces[3 * f + 2]];
    if (a == b || b == c || a == c) continue;
    // zero-area test (float, matches the numpy twin's 1e-12 threshold)
    const float *p0 = out_verts + 3 * a, *p1 = out_verts + 3 * b,
                *p2 = out_verts + 3 * c;
    float ux = p1[0] - p0[0], uy = p1[1] - p0[1], uz = p1[2] - p0[2];
    float vx = p2[0] - p0[0], vy = p2[1] - p0[1], vz = p2[2] - p0[2];
    float nx = uy * vz - uz * vy, ny = uz * vx - ux * vz,
          nz = ux * vy - uy * vx;
    if (std::sqrt((double)nx * nx + (double)ny * ny + (double)nz * nz) <=
        1e-12)
      continue;
    // duplicate test on the sorted vertex set
    int32_t s0 = a, s1 = b, s2 = c;
    if (s0 > s1) std::swap(s0, s1);
    if (s1 > s2) std::swap(s1, s2);
    if (s0 > s1) std::swap(s0, s1);
    bool fresh;
    fset.get_or_insert((uint32_t)s0, (uint32_t)s1, (uint32_t)s2, (int32_t)onf,
                       &fresh);
    if (!fresh) continue;
    out_faces[3 * onf] = a;
    out_faces[3 * onf + 1] = b;
    out_faces[3 * onf + 2] = c;
    ++onf;
  }
  *out_nv = onv;
  *out_nf = onf;
}

// ---------------------------------------------------------------------------
// Uniform vertex-cluster decimation: snap vertices to a `cell`-sized grid,
// average each cluster, drop collapsed faces. O(N) pre-pass that removes the
// bulk of a dense surface-nets mesh before the exact quadric collapse
// (490k→40k spent most of its time on trivial early collapses).
// ---------------------------------------------------------------------------
void hy3d_cluster_decimate(const float* verts, int64_t nv,
                           const int32_t* faces, int64_t nf, double cell,
                           float* out_verts, int64_t* out_nv,
                           int32_t* out_faces, int64_t* out_nf) {
  double ox = 1e300, oy = 1e300, oz = 1e300;
  for (int64_t i = 0; i < nv; ++i) {
    ox = std::min(ox, (double)verts[3 * i]);
    oy = std::min(oy, (double)verts[3 * i + 1]);
    oz = std::min(oz, (double)verts[3 * i + 2]);
  }
  const double inv = 1.0 / cell;
  OpenSet96 cells((size_t)nv);
  std::vector<int32_t> remap(nv);
  std::vector<double> sum;  // [ncell*3] position accumulators
  std::vector<int32_t> cnt;
  sum.reserve(nv / 4 * 3);
  cnt.reserve(nv / 4);
  int64_t onc = 0;
  for (int64_t i = 0; i < nv; ++i) {
    uint32_t gx = (uint32_t)((verts[3 * i] - ox) * inv);
    uint32_t gy = (uint32_t)((verts[3 * i + 1] - oy) * inv);
    uint32_t gz = (uint32_t)((verts[3 * i + 2] - oz) * inv);
    bool fresh;
    int32_t id = cells.get_or_insert(gx, gy, gz, (int32_t)onc, &fresh);
    if (fresh) {
      sum.resize(3 * (onc + 1), 0.0);
      cnt.resize(onc + 1, 0);
      ++onc;
    }
    sum[3 * id] += verts[3 * i];
    sum[3 * id + 1] += verts[3 * i + 1];
    sum[3 * id + 2] += verts[3 * i + 2];
    cnt[id]++;
    remap[i] = id;
  }
  for (int64_t c = 0; c < onc; ++c) {
    out_verts[3 * c] = (float)(sum[3 * c] / cnt[c]);
    out_verts[3 * c + 1] = (float)(sum[3 * c + 1] / cnt[c]);
    out_verts[3 * c + 2] = (float)(sum[3 * c + 2] / cnt[c]);
  }
  OpenSet96 fset((size_t)nf);
  int64_t onf = 0;
  for (int64_t f = 0; f < nf; ++f) {
    int32_t a = remap[faces[3 * f]], b = remap[faces[3 * f + 1]],
            c = remap[faces[3 * f + 2]];
    if (a == b || b == c || a == c) continue;
    int32_t s0 = a, s1 = b, s2 = c;
    if (s0 > s1) std::swap(s0, s1);
    if (s1 > s2) std::swap(s1, s2);
    if (s0 > s1) std::swap(s0, s1);
    bool fresh;
    fset.get_or_insert((uint32_t)s0, (uint32_t)s1, (uint32_t)s2, (int32_t)onf,
                       &fresh);
    if (!fresh) continue;
    out_faces[3 * onf] = a;
    out_faces[3 * onf + 1] = b;
    out_faces[3 * onf + 2] = c;
    ++onf;
  }
  *out_nv = onc;
  *out_nf = onf;
}

// ---------------------------------------------------------------------------
// Surface nets (dual contouring) over a dense grid — OpenMP, the hot host
// stage of shape generation (numpy version: volume/surface.py:_surface_nets).
// grid: [R,R,R] float32. Returns vertex/face counts written.
// ---------------------------------------------------------------------------
int32_t hy3d_surface_nets(const float* grid, int64_t R, float level,
                          float* out_verts, int64_t verts_cap,
                          int32_t* out_faces, int64_t faces_cap,
                          int64_t* out_nv, int64_t* out_nf) {
  const int64_t nc = R - 1;
  const int64_t ncells = nc * nc * nc;
  std::vector<int32_t> rank(ncells, -1);

  // pass 1: active cells + ranks (parallel count, serial prefix, parallel id)
  const int corner_off[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                                {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
  std::vector<int64_t> slab_count(nc, 0);
#pragma omp parallel for schedule(static)
  for (int64_t x = 0; x < nc; ++x) {
    int64_t cnt = 0;
    for (int64_t y = 0; y < nc; ++y) {
      for (int64_t z = 0; z < nc; ++z) {
        const float* base = grid + (x * R + y) * R + z;
        bool first = base[0] > level;
        bool mixed = false;
        for (int c = 1; c < 8 && !mixed; ++c) {
          const float v = base[(corner_off[c][0] * R + corner_off[c][1]) * R +
                               corner_off[c][2]];
          mixed = (v > level) != first;
        }
        if (mixed) {
          rank[(x * nc + y) * nc + z] = 0;  // mark; id assigned below
          ++cnt;
        }
      }
    }
    slab_count[x] = cnt;
  }
  std::vector<int64_t> slab_start(nc + 1, 0);
  for (int64_t x = 0; x < nc; ++x) slab_start[x + 1] = slab_start[x] + slab_count[x];
  const int64_t n_active = slab_start[nc];
  if (n_active > verts_cap) return -1;

#pragma omp parallel for schedule(static)
  for (int64_t x = 0; x < nc; ++x) {
    int64_t id = slab_start[x];
    for (int64_t i = (x * nc) * nc; i < ((x + 1) * nc) * nc; ++i) {
      if (rank[i] == 0) rank[i] = (int32_t)id++;
    }
  }

  // pass 2: vertex positions (mean of cube-edge crossings)
  const int edges[12][2] = {{0, 1}, {1, 2}, {2, 3}, {3, 0}, {4, 5}, {5, 6},
                            {6, 7}, {7, 4}, {0, 4}, {1, 5}, {2, 6}, {3, 7}};
#pragma omp parallel for schedule(static)
  for (int64_t x = 0; x < nc; ++x) {
    for (int64_t y = 0; y < nc; ++y) {
      for (int64_t z = 0; z < nc; ++z) {
        int32_t r = rank[(x * nc + y) * nc + z];
        if (r < 0) continue;
        float vals[8];
        for (int c = 0; c < 8; ++c)
          vals[c] = grid[((x + corner_off[c][0]) * R + y + corner_off[c][1]) * R +
                         z + corner_off[c][2]];
        float px = 0, py = 0, pz = 0;
        int n = 0;
        for (int e = 0; e < 12; ++e) {
          float va = vals[edges[e][0]], vb = vals[edges[e][1]];
          if ((va > level) == (vb > level)) continue;
          float d = vb - va;
          float t = std::fabs(d) < 1e-12f ? 0.5f
                                          : std::min(1.f, std::max(0.f, (level - va) / d));
          const int* ca = corner_off[edges[e][0]];
          const int* cb = corner_off[edges[e][1]];
          px += ca[0] + t * (cb[0] - ca[0]);
          py += ca[1] + t * (cb[1] - ca[1]);
          pz += ca[2] + t * (cb[2] - ca[2]);
          ++n;
        }
        float inv = n ? 1.f / n : 0.f;
        out_verts[3 * r] = (x + px * inv);
        out_verts[3 * r + 1] = (y + py * inv);
        out_verts[3 * r + 2] = (z + pz * inv);
      }
    }
  }

  // pass 3: faces per sign-changing grid edge (3 axis sweeps), deterministic
  // count→prefix→fill ordering (no atomic append races).
  int64_t nf_total = 0;
  const int64_t stride_cells[3] = {nc * nc, nc, 1};
  for (int d = 0; d < 3; ++d) {
    const int u = (d + 1) % 3, v = (d + 2) % 3;
    std::vector<int64_t> cnt(nc, 0);
    for (int phase = 0; phase < 2; ++phase) {
      std::vector<int64_t> start(nc + 1, 0);
      if (phase == 1) {
        for (int64_t x = 0; x < nc; ++x) start[x + 1] = start[x] + cnt[x];
        if (nf_total + start[nc] > faces_cap / 2) return -2;
      }
#pragma omp parallel for schedule(static)
      for (int64_t x = 0; x < nc; ++x) {
        int64_t w = phase ? (nf_total + start[x]) : 0;
        int64_t idx[3];
        for (int64_t y = 0; y < nc; ++y) {
          for (int64_t z = 0; z < nc; ++z) {
            idx[0] = x; idx[1] = y; idx[2] = z;
            if (idx[u] == 0 || idx[v] == 0) continue;
            const float lo = grid[(x * R + y) * R + z];
            int64_t pi[3] = {x, y, z};
            pi[d] += 1;
            const float hi = grid[(pi[0] * R + pi[1]) * R + pi[2]];
            const bool li = lo > level;
            if (li == (hi > level)) continue;
            const int64_t c0 = (x * nc + y) * nc + z;
            const int32_t q0 = rank[c0];
            const int32_t q1 = rank[c0 - stride_cells[u]];
            const int32_t q2 = rank[c0 - stride_cells[u] - stride_cells[v]];
            const int32_t q3 = rank[c0 - stride_cells[v]];
            if (q0 < 0 || q1 < 0 || q2 < 0 || q3 < 0) continue;
            if (phase == 0) {
              ++cnt[x];
            } else {
              int64_t f = 2 * w;
              if (li) {
                out_faces[3 * f] = q0; out_faces[3 * f + 1] = q1; out_faces[3 * f + 2] = q2;
                out_faces[3 * f + 3] = q0; out_faces[3 * f + 4] = q2; out_faces[3 * f + 5] = q3;
              } else {
                out_faces[3 * f] = q3; out_faces[3 * f + 1] = q2; out_faces[3 * f + 2] = q1;
                out_faces[3 * f + 3] = q3; out_faces[3 * f + 4] = q1; out_faces[3 * f + 5] = q0;
              }
              ++w;
            }
          }
        }
      }
      if (phase == 1) nf_total += start[nc];
    }
  }
  *out_nv = n_active;
  *out_nf = 2 * nf_total;
  return 0;
}

// ---------------------------------------------------------------------------
// Surface nets from COMPACTED ACTIVE CELLS (the active-cell extraction path:
// extract_active_cells → here). Mirrors the numpy twin
// volume/surface.py:_sn_from_actives — one pass, no [K,12,3] float
// intermediates (the numpy version materializes ~200 MB at K=245k).
//
// cells: [K,3] int32 cell coords SORTED by flat id x*nc*nc + y*nc + z.
// vals:  [K,8] float32 corner values (corner order {0,0,0},{1,0,0},{1,1,0},
//        {0,1,0},{0,0,1},{1,0,1},{1,1,1},{0,1,1}).
// out_verts: [K,3] (one dual vertex per active cell, lattice coords).
// Faces match the twin's layout exactly: per direction d∈{x,y,z}, first the
// [0,1,2] triangle of every selected cell in cell order, then the [0,2,3]
// triangles. Returns 0, or -1 when faces_cap would overflow.
// ---------------------------------------------------------------------------
int32_t hy3d_sn_actives(const int32_t* cells, const float* vals, int64_t K,
                        int64_t nc, float level, float* out_verts,
                        int32_t* out_faces, int64_t faces_cap,
                        int64_t* out_nf) {
  const int corner_off[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                                {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
  const int edges[12][2] = {{0, 1}, {1, 2}, {2, 3}, {3, 0}, {4, 5}, {5, 6},
                            {6, 7}, {7, 4}, {0, 4}, {1, 5}, {2, 6}, {3, 7}};
  std::vector<int64_t> flatid(K);
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < K; ++k) {
    const int32_t* c = cells + 3 * k;
    flatid[k] = ((int64_t)c[0] * nc + c[1]) * nc + c[2];
  }

  // vertex pass: mean of cube-edge crossings (same edge order and same
  // degenerate-denominator rule as the numpy twin)
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < K; ++k) {
    const float* v = vals + 8 * k;
    const int32_t* c = cells + 3 * k;
    float px = 0.f, py = 0.f, pz = 0.f;
    int n = 0;
    for (int e = 0; e < 12; ++e) {
      const float va = v[edges[e][0]], vb = v[edges[e][1]];
      if ((va > level) == (vb > level)) continue;
      float d = vb - va;
      if (std::fabs(d) < 1e-12f) d = 1e-12f;
      float t = (level - va) / d;
      t = std::min(1.f, std::max(0.f, t));
      const int* ca = corner_off[edges[e][0]];
      const int* cb = corner_off[edges[e][1]];
      px += ca[0] + t * (float)(cb[0] - ca[0]);
      py += ca[1] + t * (float)(cb[1] - ca[1]);
      pz += ca[2] + t * (float)(cb[2] - ca[2]);
      ++n;
    }
    const float inv = n ? 1.f / (float)n : 0.f;
    out_verts[3 * k] = c[0] + px * inv;
    out_verts[3 * k + 1] = c[1] + py * inv;
    out_verts[3 * k + 2] = c[2] + pz * inv;
  }

  // face pass: each cell owns its 3 min-corner lattice edges; neighbors by
  // binary search over the sorted flat ids. Sequential fill = deterministic
  // twin-identical ordering (two tri blocks per direction).
  const int end_corner[3] = {1, 3, 4};  // +x, +y, +z sign partners of corner0
  const int64_t strides[3] = {nc * nc, nc, 1};
  auto lookup = [&](int64_t id) -> int32_t {
    int64_t lo = 0, hi = K;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (flatid[mid] < id) lo = mid + 1; else hi = mid;
    }
    return (lo < K && flatid[lo] == id) ? (int32_t)lo : -1;
  };
  int64_t nf = 0;
  std::vector<int32_t> quads;  // q0,q1,q2,q3 per selected cell of one dir
  for (int d = 0; d < 3; ++d) {
    const int u = (d + 1) % 3, w = (d + 2) % 3;
    const int64_t su = strides[u], sv = strides[w];
    quads.clear();
    for (int64_t k = 0; k < K; ++k) {
      const float* v = vals + 8 * k;
      const bool occ0 = v[0] > level;
      if (occ0 == (v[end_corner[d]] > level)) continue;
      const int32_t* c = cells + 3 * k;
      if (c[u] <= 0 || c[w] <= 0) continue;
      const int64_t base = flatid[k];
      const int32_t q1 = lookup(base - su);
      const int32_t q2 = lookup(base - su - sv);
      const int32_t q3 = lookup(base - sv);
      if (q1 < 0 || q2 < 0 || q3 < 0) continue;
      if (occ0) {
        quads.push_back((int32_t)k); quads.push_back(q1);
        quads.push_back(q2); quads.push_back(q3);
      } else {  // flipped orientation = reversed quad
        quads.push_back(q3); quads.push_back(q2);
        quads.push_back(q1); quads.push_back((int32_t)k);
      }
    }
    const int64_t nq = (int64_t)quads.size() / 4;
    if (nf + 2 * nq > faces_cap) return -1;
    for (int64_t i = 0; i < nq; ++i) {  // block A: [0,1,2]
      out_faces[3 * (nf + i)] = quads[4 * i];
      out_faces[3 * (nf + i) + 1] = quads[4 * i + 1];
      out_faces[3 * (nf + i) + 2] = quads[4 * i + 2];
    }
    for (int64_t i = 0; i < nq; ++i) {  // block B: [0,2,3]
      out_faces[3 * (nf + nq + i)] = quads[4 * i];
      out_faces[3 * (nf + nq + i) + 1] = quads[4 * i + 2];
      out_faces[3 * (nf + nq + i) + 2] = quads[4 * i + 3];
    }
    nf += 2 * nq;
  }
  *out_nf = nf;
  return 0;
}

}  // extern "C"
