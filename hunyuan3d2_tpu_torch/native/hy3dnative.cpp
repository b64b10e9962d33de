// hy3dnative — native CPU runtime components, the part of
// hunyuan3d2_tpu/native/hy3dnative.cpp that the PyTorch port binds (the port
// imports nothing of the JAX package). One change: hy3d_grid_put_linear
// hands its scratch to the OpenMP workers through plain pointers (see there).
//
// Kept here:
//   * z-buffer triangle rasterization with a deterministic packed
//     depth|face-id resolve (the UV unwrap's chart overlap guard),
//   * mesh_processor vertex-graph texture inpainting and the push-pull
//     hole fill (the texture inpaint),
//   * the bilinear splat of the host bake (not on the port's path yet).
//
// C ABI for ctypes binding. Parallel loops use OpenMP with deterministic
// reductions.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
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

}  // extern "C"
