"""UV unwrapping (xatlas replacement, from scratch), copied from
hunyuan3d2_tpu/geometry/uv.py for the PyTorch port: the same charts, the
same packing, the same UVs (the native rasterizer is the port's copy).

Behavioral parity: reference hy3dgen/texgen/utils/uv_warp_utils.py:19-33
(``mesh_uv_wrap``: xatlas.parametrize → remapped verts/faces + per-vertex
uv, with a face-count guard). This environment has no xatlas, so the
framework ships its own charting parametrizer:

  1. region-growing charts over the face-adjacency graph, cone-limited
     around each chart's running average normal (k-means-style second
     pass), with majority-filter boundary smoothing and greedy merging;
  2. per-chart parameterization: free-boundary LSCM (Lévy 2002 — the same
     parameterization xatlas uses) refined by ARAP local/global iterations
     (Liu 2008) to pull stretch distortion down, with planar projection as
     the fallback and a rasterized-overlap injectivity guard that splits
     offending charts;
  3. charts are packed into the unit square by a shelf packer with a binary
     search on global scale, leaving a per-chart margin so bilinear texture
     lookups don't bleed across charts;
  4. vertices shared by multiple charts are split (per-corner attribution),
     exactly what xatlas' vmapping does.

Measured on the test sphere (tests/test_render_uv.py seam metric):
seam-length ratio ~4.1 and stretch spread (p90/p10) ~1.6 — inside the
xatlas class (~3-6 seam). Charts are injective and padded, which is what
the paint pipeline's bake/inpaint requires.
"""

from __future__ import annotations

import functools

import numpy as np

from hunyuan3d2_tpu_torch.geometry.mesh import Mesh

_AXES = np.array([
    [1, 0, 0], [-1, 0, 0],
    [0, 1, 0], [0, -1, 0],
    [0, 0, 1], [0, 0, -1],
], np.float32)

# minimum chart size under which sliver charts are absorbed into neighbors
# (_absorb_small_charts / _coalesce_split); also the bound below which the
# parameterizer's bucket split is a guaranteed no-op (see _parameterize_charts)
MIN_COALESCE_FACES = 12

# in-plane basis (u, v) per axis, chosen right-handed w.r.t. the axis so
# projected triangles keep their orientation
_BASES = {
    0: ([0, 1, 0], [0, 0, 1]),
    1: ([0, 0, 1], [0, 1, 0]),
    2: ([0, 0, 1], [1, 0, 0]),
    3: ([1, 0, 0], [0, 0, 1]),
    4: ([1, 0, 0], [0, 1, 0]),
    5: ([0, 1, 0], [1, 0, 0]),
}


def _face_components_in_bucket(faces: np.ndarray, bucket: np.ndarray,
                               n_vertices: int) -> np.ndarray:
    """Union-find over faces; union only across edges whose two faces share
    the same bucket. Returns per-face chart id."""
    nf = len(faces)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    face_of_edge = np.tile(np.arange(nf), 3)
    key = edges[:, 0].astype(np.int64) * n_vertices + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    face_s = face_of_edge[order]
    same = key_s[1:] == key_s[:-1]
    fa, fb = face_s[:-1][same], face_s[1:][same]
    keep = bucket[fa] == bucket[fb]
    fa, fb = fa[keep], fb[keep]
    if nf < 2048:
        # small charts (the injectivity fixpoint's split path calls this
        # once per offending chart): a python union-find on ≤3·nf edges
        # beats scipy's csr validation + csgraph call by ~30×
        parent = list(range(nf))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b in zip(fa.tolist(), fb.tolist()):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
        labels = np.fromiter((find(i) for i in range(nf)), np.int64, nf)
    else:
        import scipy.sparse
        import scipy.sparse.csgraph

        g = scipy.sparse.coo_matrix(
            (np.ones(len(fa), np.int8), (fa, fb)), shape=(nf, nf))
        _, labels = scipy.sparse.csgraph.connected_components(g, directed=False)
    # relabel in root-sorted order for a stable, deterministic id space
    _, chart = np.unique(labels, return_inverse=True)
    return chart


def _face_adjacency(faces: np.ndarray, n_vertices: int) -> np.ndarray:
    """[F, 3] neighbor face ids over shared edges (-1 where boundary)."""
    nf = len(faces)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    face_of_edge = np.tile(np.arange(nf), 3)
    key = edges[:, 0].astype(np.int64) * n_vertices + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key_s, face_s = key[order], face_of_edge[order]
    nbr = np.full((nf, 3), -1, np.int64)
    same = np.nonzero(key_s[1:] == key_s[:-1])[0]
    # both directions of every shared-edge pair, in the original loop's
    # insertion order, then one vectorized per-face slot assignment
    src = np.concatenate([face_s[same], face_s[same + 1]])
    dst = np.concatenate([face_s[same + 1], face_s[same]])
    interleave = np.empty(2 * len(same), np.int64)
    interleave[0::2] = np.arange(len(same))
    interleave[1::2] = np.arange(len(same)) + len(same)
    src, dst = src[interleave], dst[interleave]
    o = np.argsort(src, kind="stable")
    src_s, dst_s = src[o], dst[o]
    starts = np.searchsorted(src_s, np.arange(nf))
    slot = np.arange(len(src_s)) - starts[src_s]
    m = slot < 3
    nbr[src_s[m], slot[m]] = dst_s[m]
    return nbr


def _smooth_buckets(fn: np.ndarray, bucket: np.ndarray, nbr: np.ndarray,
                    iters: int = 4, min_dot: float = 0.25) -> np.ndarray:
    """Majority-filter the per-face bucket assignment over the adjacency
    graph: a face joins the bucket shared by ≥2 of its neighbors when its
    normal still projects positively onto that bucket's axis (keeps the
    axis-projection orientation guarantee). Smooths the jagged boundaries of
    the argmax bucketing — the dominant source of seam length — and absorbs
    single-face slivers."""
    bucket = bucket.copy()
    for _ in range(iters):
        nb = np.where(nbr >= 0, bucket[np.maximum(nbr, 0)], -1)  # [F, 3]
        # majority bucket among neighbors (≥2 agreeing)
        maj = np.full(len(bucket), -1, np.int64)
        for a in range(3):
            for b in range(a + 1, 3):
                agree = (nb[:, a] == nb[:, b]) & (nb[:, a] >= 0)
                maj = np.where(agree & (maj < 0), nb[:, a], maj)
        dots = np.einsum("fc,bc->fb", fn, _AXES)
        ok = (maj >= 0) & (maj != bucket) & \
             (dots[np.arange(len(bucket)), np.maximum(maj, 0)] > min_dot)
        if not ok.any():
            break
        bucket[ok] = maj[ok]
    return bucket


# charts above this count skip the O(N·S) skyline and use the O(N log N)
# rotated-shelf packer (fragmented meshes produce thousands of tiny charts
# and the unwrap runs on the serving path, overlapped with the denoise)
SKYLINE_MAX_CHARTS = 800


def _try_shelf(dims: np.ndarray, scale: float, margin: float):
    """Tallest-first shelf pack at a fixed scale. dims: [N,2] (callers pass
    portrait-rotated w ≤ h sizes). → pos [N,2] or None."""
    order = np.argsort(-dims[:, 1])
    x = y = shelf_h = 0.0
    pos = np.zeros((len(dims), 2))
    for i in order:
        w = dims[i, 0] * scale + 2 * margin
        h = dims[i, 1] * scale + 2 * margin
        if w > 1.0 or h > 1.0:
            return None
        if x + w > 1.0:
            y += shelf_h
            x = 0.0
            shelf_h = 0.0
        if y + h > 1.0:
            return None
        pos[i] = (x + margin, y + margin)
        x += w
        shelf_h = max(shelf_h, h)
    return pos


def _try_skyline(sizes: np.ndarray, scale: float, margin: float):
    """Bottom-left skyline pack with a per-rect 90°-rotation choice (the
    xatlas-style packer). sizes: [N,2] raw chart bboxes.
    → (pos [N,2], rot [N] bool) or None when this scale doesn't fit."""
    n = len(sizes)
    order = np.argsort(-(sizes.max(axis=1)))
    pos = np.zeros((n, 2))
    rot = np.zeros(n, bool)
    # skyline as breakpoints: segment i spans [xs[i], xs[i+1]) (last → 1.0)
    # at height ys[i]
    xs = [0.0]
    ys = [0.0]
    eps = 1e-12

    def best_spot(w, h):
        """Lowest-then-leftmost placement for a w×h rect, or None."""
        best = None
        m = len(xs)
        for i in range(m):
            x = xs[i]
            if x + w > 1.0 + eps:
                break
            y = ys[i]
            j = i + 1
            while j < m and xs[j] < x + w - eps:
                y = max(y, ys[j])
                j += 1
            if y + h <= 1.0 + eps and (best is None or (y, x) < best):
                best = (y, x)
        return best

    def place(x, w, y_new):
        """Raise the skyline over [x, x+w) to y_new (rebuild by sampling
        heights at merged breakpoints)."""
        nonlocal xs, ys
        x_end = min(x + w, 1.0)
        pts = sorted(set(xs) | {x, x_end})

        def h_at(px):
            i = max(int(np.searchsorted(xs, px + 1e-15)) - 1, 0)
            return ys[i]

        nxs, nys = [], []
        for px in pts:
            if px >= 1.0 - eps:
                continue
            hh = y_new if (x - eps <= px < x_end - eps) else h_at(px)
            if nys and abs(nys[-1] - hh) < eps:
                continue
            nxs.append(px)
            nys.append(hh)
        xs, ys = nxs, nys

    for i in order:
        w0 = sizes[i, 0] * scale + 2 * margin
        h0 = sizes[i, 1] * scale + 2 * margin
        cands = []
        s0 = best_spot(w0, h0)
        if s0 is not None:
            cands.append((s0[0] + h0, s0[0], s0[1], False, w0, h0))
        if abs(w0 - h0) > eps:
            s1 = best_spot(h0, w0)
            if s1 is not None:
                cands.append((s1[0] + w0, s1[0], s1[1], True, h0, w0))
        if not cands:
            return None
        _, y, x, r, w, h = min(cands)
        pos[i] = (x + margin, y + margin)
        rot[i] = r
        place(x, w, y + h)
    return pos, rot


# raster packing (FFT placement search) costs ~20-40 ms per chart; above
# this chart count fall back to the bbox skyline
RASTER_MAX_CHARTS = 160


def _rasterize_chart(pts: np.ndarray, tris: np.ndarray, s: float, grid: int,
                     mcells: int) -> np.ndarray:
    """Chart footprint bitmap at ``grid`` cells per unit-canvas axis, dilated
    by the margin (+1 cell against raster quantization). pts: local uv with
    min at 0."""
    import cv2

    w = float(pts[:, 0].max())
    h = float(pts[:, 1].max())
    pad = mcells + 1
    cw = int(np.ceil(w * s * grid)) + 2 * pad + 1
    ch = int(np.ceil(h * s * grid)) + 2 * pad + 1
    img = np.zeros((ch, cw), np.uint8)
    ipts = np.round(pts * (s * grid)).astype(np.int32) + pad
    cv2.fillPoly(img, [ipts[t] for t in tris], 1)
    k = 2 * pad + 1
    img = cv2.dilate(img, np.ones((k, k), np.uint8))
    return img.astype(bool)


def _raster_pack(sizes: np.ndarray, margin: float, footprints, grid: int = 512):
    """xatlas-style raster packing: each chart is placed by its rasterized
    footprint — an FFT-backed cv2.matchTemplate correlation against the
    atlas bitmap finds the lowest collision-free spot, trying both 90°
    orientations — so charts nest into voids and concavities. Bbox packers
    cap occupancy at bbox_fill × bbox_packing ≈ 0.4 in practice; thin
    curved charts (a bevel ring) fill < 0.3 of their bbox. A scale search
    re-packs until the square canvas is tightly filled.

    footprints: per chart (pts [M,2] local uv with min 0, tris [T,3] local).
    Returns (offsets [N,2], scale, rot [N] bool)."""
    import cv2

    sizes = np.asarray(sizes, np.float64)
    n = len(sizes)
    total = float((sizes[:, 0] * sizes[:, 1]).sum())
    mcells = max(1, int(round(margin * grid)))
    pad = mcells + 1
    W = grid
    order = np.argsort(-(sizes.max(axis=1)))

    def pack_at(s):
        """→ (pos_cells, rot, h_used) — packs every chart (open-top canvas),
        or None when a chart exceeds the canvas in some dimension."""
        atlas = np.zeros((2 * grid, W), np.uint8)
        pos = np.zeros((n, 2), np.int64)
        rot = np.zeros(n, bool)
        h_used = 0
        for i in order:
            pts, tris = footprints[i]
            best = None
            if h_used == 0:
                # empty atlas: (0,0) is optimal — skip the correlation
                # search and the rotation candidate (rasterizing a 40k-tri
                # chart twice per scale attempt dominated few-chart packs)
                bm = _rasterize_chart(pts, tris, s, grid, mcells)
                ch, cw = bm.shape
                if cw <= W and ch <= atlas.shape[0]:
                    best = (ch, 0, 0, False, bm)
            for r in () if best is not None else (False, True):
                p = pts if not r else np.stack(
                    [sizes[i, 1] - pts[:, 1], pts[:, 0]], axis=1)
                bm = _rasterize_chart(p, tris, s, grid, mcells)
                ch, cw = bm.shape
                if cw > W or ch > atlas.shape[0]:
                    continue
                # free spots: zero correlation between the atlas band and
                # the footprint; placing at y == h_used is always free, so
                # the band up to h_used + ch always yields a spot
                band_h = min(h_used + ch, atlas.shape[0])
                res = cv2.matchTemplate(atlas[:band_h], bm.astype(np.uint8),
                                        cv2.TM_CCORR)
                ys, xs = np.nonzero(res < 0.5)
                if len(ys) == 0:
                    continue
                j = np.lexsort((xs, ys))[0]
                y, x = int(ys[j]), int(xs[j])
                if best is None or (y + ch, y, x) < best[:3]:
                    best = (y + ch, y, x, r, bm)
            if best is None:
                return None
            _, y, x, r, bm = best
            ch, cw = bm.shape
            atlas[y:y + ch, x:x + cw] |= bm
            h_used = max(h_used, y + ch)
            pos[i] = (x, y)
            rot[i] = r
        return pos, rot, h_used

    # scale search: descend until the packing fits the square canvas, then
    # one growth probe if there's slack (h_used ≪ grid wastes the top band)
    s = min(0.95 / max(np.sqrt(total), 1e-12),
            0.9 * (W - 2 * pad) / grid / max(float(sizes.max()), 1e-12))
    fit = None
    for _ in range(8):
        r = pack_at(s)
        if r is not None and r[2] <= grid:
            fit = (s, r)
            break
        shrink = 0.9 if r is None else min(0.97, np.sqrt(grid / r[2]))
        s *= shrink
    if fit is None:
        raise RuntimeError("raster UV packing failed")
    s0, r0 = fit
    if r0[2] < 0.93 * grid:
        s_try = s0 * min(1.25, 0.98 * np.sqrt(grid / max(r0[2], 1)))
        r = pack_at(s_try)
        if r is not None and r[2] <= grid:
            fit = (s_try, r)
    s, (pos, rot, _) = fit
    return (pos + pad) / grid, s, rot


def _pack_charts(sizes: np.ndarray, margin: float, footprints=None):
    """Pack chart bboxes (w,h) into the unit square, maximizing occupancy.
    With ``footprints`` and ≤ RASTER_MAX_CHARTS charts, uses the xatlas-style
    raster packer; otherwise a skyline (≤ SKYLINE_MAX_CHARTS) or rotated
    shelf with a bisection on the global scale. Returns (offsets [N,2],
    scale, rot [N] bool) — rot marks charts placed 90°-rotated (the caller
    maps local (u,v) → (h−v, u) for those)."""
    if footprints is not None and len(sizes) <= RASTER_MAX_CHARTS:
        try:
            return _raster_pack(np.asarray(sizes, np.float64), margin,
                                footprints)
        except Exception:
            pass  # bbox packers below are the fallback
    sizes = np.asarray(sizes, np.float64)
    n = len(sizes)
    total = float((sizes[:, 0] * sizes[:, 1]).sum())
    s_hi = 1.0 / max(np.sqrt(total), 1e-12)     # occupancy-1 upper bound

    if n <= SKYLINE_MAX_CHARTS:
        def attempt(s):
            return _try_skyline(sizes, s, margin)
    else:
        landscape = sizes[:, 0] > sizes[:, 1]
        dims = sizes.copy()
        dims[landscape] = dims[landscape][:, ::-1]

        def attempt(s):
            p = _try_shelf(dims, s, margin)
            return None if p is None else (p, landscape.copy())

    # find a feasible scale by geometric descent, then bisect toward the
    # tightest fit (the old packer stopped at the first success, leaving
    # up to ~35% of the atlas empty)
    s_lo, ok = None, None
    s = 0.92 * s_hi
    for _ in range(60):
        r = attempt(s)
        if r is not None:
            s_lo, ok = s, r
            break
        s *= 0.9
    if ok is None:
        raise RuntimeError("UV packing failed")
    hi = min(s_lo / 0.9, s_hi)
    for _ in range(7):
        mid = 0.5 * (s_lo + hi)
        if mid <= s_lo * 1.005:
            break
        r = attempt(mid)
        if r is not None:
            s_lo, ok = mid, r
        else:
            hi = mid
    pos, rot = ok
    return pos, s_lo, rot


def _grow_charts(fn: np.ndarray, areas: np.ndarray, nbr: np.ndarray,
                 max_angle_deg: float = 88.0, passes: int = 2) -> np.ndarray:
    """Region-growing charting (the xatlas approach, simplified): charts
    grow from seeds across the adjacency graph in best-fit-first order,
    constrained to a normal cone around the chart's running average normal.
    A second pass re-grows with the converged chart normals (k-means style),
    which straightens boundaries. Returns per-face chart ids.

    Compared to fixed 6-axis bucketing this cuts seam length ~2-3×: charts
    align to the surface instead of to the world axes, so boundaries fall
    where the surface actually bends."""
    import heapq
    from math import sqrt

    nf = len(fn)
    cos_max = float(np.cos(np.radians(max_angle_deg)))
    order = np.argsort(-areas)  # seed preference: biggest faces first
    chart = np.full(nf, -1, np.int64)
    # hot loop works on plain python lists: per-element numpy scalar ops
    # (fn[i] @ n, np.linalg.norm of a 3-vector) cost ~1 µs each and the
    # greedy growth does ~10·F of them — lists are ~5× faster
    fnl = fn.tolist()
    areal = areas.tolist()
    nbrl = nbr.tolist()
    chart_normals = None
    for _pass in range(passes):
        chart[:] = -1
        chart_l = [-1] * nf
        normals = []   # running (unnormalized) area-weighted normal per chart
        nnorm = []     # cached normalized normal per chart
        heap = []
        counter = 0

        def seed(face):
            nonlocal counter
            c = len(normals)
            if chart_normals is not None and c < len(chart_normals):
                nx, ny, nz = chart_normals[c]
            else:
                a = areal[face]
                fx, fy, fz = fnl[face]
                nx, ny, nz = fx * a, fy * a, fz * a
            normals.append([nx, ny, nz])
            ln = max(sqrt(nx * nx + ny * ny + nz * nz), 1e-12)
            nnorm.append([nx / ln, ny / ln, nz / ln])
            chart_l[face] = c
            fx, fy, fz = fnl[face]
            for nb in nbrl[face]:
                if nb >= 0 and chart_l[nb] < 0:
                    gx, gy, gz = fnl[nb]
                    heapq.heappush(
                        heap, (1.0 - (gx * fx + gy * fy + gz * fz),
                               counter, nb, c))
                    counter += 1

        seed_iter = iter(order.tolist())
        seed(next(seed_iter))
        assigned = 1
        frozen = chart_normals is not None
        while assigned < nf:
            while heap:
                cost, _, face, c = heapq.heappop(heap)
                if chart_l[face] >= 0:
                    continue
                nn = nnorm[c]
                fx, fy, fz = fnl[face]
                if fx * nn[0] + fy * nn[1] + fz * nn[2] < cos_max:
                    continue  # outside the cone: wait for a better chart
                chart_l[face] = c
                assigned += 1
                if not (frozen and c < len(chart_normals)):
                    a = areal[face]
                    n_c = normals[c]
                    n_c[0] += fx * a
                    n_c[1] += fy * a
                    n_c[2] += fz * a
                    ln = max(sqrt(n_c[0] ** 2 + n_c[1] ** 2 + n_c[2] ** 2),
                             1e-12)
                    nn = nnorm[c] = [n_c[0] / ln, n_c[1] / ln, n_c[2] / ln]
                for nb in nbrl[face]:
                    if nb >= 0 and chart_l[nb] < 0:
                        gx, gy, gz = fnl[nb]
                        heapq.heappush(
                            heap,
                            (1.0 - (gx * nn[0] + gy * nn[1] + gz * nn[2]),
                             counter, nb, c))
                        counter += 1
            if assigned < nf:
                # no reachable face fits any existing chart: new seed
                for s in seed_iter:
                    if chart_l[s] < 0:
                        seed(s)
                        assigned += 1
                        break
        chart_normals = nnorm
        chart = np.asarray(chart_l, np.int64)
    return _smooth_chart_boundaries(fn, chart, np.asarray(chart_normals),
                                    nbr, cos_max)


def _smooth_chart_boundaries(fn: np.ndarray, chart: np.ndarray,
                             chart_normals: np.ndarray, nbr: np.ndarray,
                             cos_max: float, iters: int = 10) -> np.ndarray:
    """Majority-filter chart ids over the adjacency graph: a face whose ≥2
    neighbors agree on another chart joins it when its normal stays inside
    that chart's cone. Greedy heap growth leaves staircase boundaries where
    two charts fit equally well — this straightens them (same idea as
    _smooth_buckets, but against grown charts)."""
    chart = chart.copy()
    for _ in range(iters):
        nb = np.where(nbr >= 0, chart[np.maximum(nbr, 0)], -1)  # [F, 3]
        maj = np.full(len(chart), -1, np.int64)
        for a in range(3):
            for b in range(a + 1, 3):
                agree = (nb[:, a] == nb[:, b]) & (nb[:, a] >= 0)
                maj = np.where(agree & (maj < 0), nb[:, a], maj)
        cand = np.maximum(maj, 0)
        fit = np.einsum("fc,fc->f", fn, chart_normals[cand])
        ok = (maj >= 0) & (maj != chart) & (fit > cos_max)
        if not ok.any():
            break
        chart[ok] = maj[ok]
    return chart


def _basis_scalar(nx: float, ny: float, nz: float):
    """Scalar core of _chart_basis: right-handed in-plane (u, w) tuples for
    a unit normal. ONE copy of the sign-sensitive convention (u = e_k ×
    normal for the smallest |normal| component) shared by the numpy wrapper
    and the tiny-chart pure-python path."""
    ax, ay, az = abs(nx), abs(ny), abs(nz)
    if ax <= ay and ax <= az:
        ux, uy, uz = 0.0, -nz, ny
    elif ay <= az:
        ux, uy, uz = nz, 0.0, -nx
    else:
        ux, uy, uz = -ny, nx, 0.0
    ln = max((ux * ux + uy * uy + uz * uz) ** 0.5, 1e-12)
    ux, uy, uz = ux / ln, uy / ln, uz / ln
    wx = ny * uz - nz * uy
    wy = nz * ux - nx * uz
    wz = nx * uy - ny * ux
    return (ux, uy, uz), (wx, wy, wz)


def _chart_basis(normal: np.ndarray):
    """Right-handed in-plane (u, v) basis orthogonal to ``normal``.
    Scalar arithmetic: np.cross/norm on single 3-vectors cost ~100 µs of
    dispatch overhead and this runs once per chart (thousands of times on
    fragmented meshes)."""
    u, w = _basis_scalar(float(normal[0]), float(normal[1]), float(normal[2]))
    return np.array(u, np.float64), np.array(w, np.float64)


def _chart_overlap_ratio(uv: np.ndarray, tris: np.ndarray, res: int = 128):
    """Σ triangle areas / covered-cell area after rasterizing the chart's UV
    triangles onto a small grid. ≈1 for injective charts, >1 when sheets
    overlap (a spiral-ramp chart that passed the cone test)."""
    lo = uv.min(0)
    span = max(float((uv.max(0) - lo).max()), 1e-12)
    q = (uv - lo) / span  # [0,1]²
    if len(tris) <= 8:
        # tiny charts (fragmented meshes produce thousands): a vectorized
        # point-in-triangle coverage on a 64² grid beats the native
        # rasterizer's per-call dispatch overhead ~5×. Restricted to ≤8
        # triangles: larger charts can be thin (bevel rings) where the
        # coarse grid under-counts coverage and over-triggers splitting
        g = (np.arange(64, dtype=np.float32) + 0.5) / 64.0
        px = np.repeat(g, 64)
        py = np.tile(g, 64)
        a = q[tris[:, 0]].astype(np.float32)
        b = q[tris[:, 1]].astype(np.float32)
        c = q[tris[:, 2]].astype(np.float32)

        def edge(p0, p1):
            return ((p1[:, None, 0] - p0[:, None, 0])
                    * (py[None] - p0[:, None, 1])
                    - (p1[:, None, 1] - p0[:, None, 1])
                    * (px[None] - p0[:, None, 0]))

        e0, e1, e2 = edge(a, b), edge(b, c), edge(c, a)
        inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                  | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
        covered = float(inside.any(0).mean())
        ab = q[tris[:, 1]] - q[tris[:, 0]]
        ac = q[tris[:, 2]] - q[tris[:, 0]]
        tri_area = float(np.abs(ab[:, 0] * ac[:, 1]
                                - ab[:, 1] * ac[:, 0]).sum() / 2)
        if covered <= 0:
            return 1.0
        return tri_area / covered
    clip = np.concatenate([(q * 2 - 1).astype(np.float32),
                           np.zeros((len(q), 1), np.float32),
                           np.ones((len(q), 1), np.float32)], axis=1)
    try:
        from hunyuan3d2_tpu_torch import native

        fid, _, _ = native.rasterize(clip, tris.astype(np.int32), res, res)
        covered = float((fid >= 0).sum()) / (res * res) * 4.0  # NDC area 2×2
    except Exception:  # pragma: no cover
        return 1.0
    a = q[tris[:, 1]] - q[tris[:, 0]]
    b = q[tris[:, 2]] - q[tris[:, 0]]
    tri_area = float(np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]).sum() / 2)
    if covered <= 0:
        return 1.0
    return tri_area * 4.0 / covered  # both in the 2×2 NDC square


def _merge_charts(fn: np.ndarray, areas: np.ndarray, f: np.ndarray,
                  chart: np.ndarray, nbr: np.ndarray,
                  max_angle_deg: float = 98.0) -> np.ndarray:
    """Greedy chart merging (xatlas' post-pass): absorb a chart into an
    adjacent one when every face of the union stays within the cone around
    the union's average normal. Region growing strands small leftover charts
    in the gaps between big ones — merging removes their entire boundary
    from the seam set. Smallest charts are merged first."""
    cos_lim = np.cos(np.radians(max_angle_deg))
    n_charts = int(chart.max()) + 1
    # members via one argsort (the python append loop is O(F) dict ops)
    order = np.argsort(chart, kind="stable")
    bounds = np.searchsorted(chart[order], np.arange(n_charts + 1))
    members = [order[bounds[c]:bounds[c + 1]].tolist()
               for c in range(n_charts)]
    normals = np.zeros((n_charts, 3))
    np.add.at(normals, chart, fn * areas[:, None])
    carea = np.zeros(n_charts)
    np.add.at(carea, chart, areas)
    # chart adjacency from face adjacency (vectorized pair extraction)
    adj = [set() for _ in range(n_charts)]
    fi = np.repeat(np.arange(len(f)), 3)
    nbf = nbr.ravel()
    valid = nbf >= 0
    ca, cb = chart[fi[valid]], chart[nbf[valid]]
    differ = ca != cb
    for a, b in np.unique(np.stack([ca[differ], cb[differ]], 1),
                          axis=0).tolist():
        adj[a].add(b)
        adj[b].add(a)
    alive = np.ones(n_charts, bool)
    # cached normal magnitudes: np.linalg.norm per neighbor pair dominated
    # this loop on many-chart meshes
    nmag = np.maximum(np.linalg.norm(normals, axis=1), 1e-12)
    changed = True
    while changed:
        changed = False
        order = sorted(np.nonzero(alive)[0], key=lambda c: carea[c])
        for c in order:
            if not alive[c] or not adj[c]:
                continue
            best, best_fit = -1, -1.0
            nc = normals[c] / nmag[c]
            for d in sorted(adj[c]):
                if not alive[d] or d == c:
                    continue
                fit = float(nc @ normals[d]) / nmag[d]
                if fit > best_fit:
                    best_fit, best = fit, d
            if best < 0:
                continue
            un = normals[c] + normals[best]
            un = un / max(np.linalg.norm(un), 1e-12)
            faces_u = members[c] + members[best]
            if float((fn[faces_u] @ un).min()) < cos_lim:
                continue
            # merge c into best
            members[best] = faces_u
            members[c] = []
            normals[best] = normals[best] + normals[c]
            nmag[best] = max(np.linalg.norm(normals[best]), 1e-12)
            carea[best] += carea[c]
            adj[best] |= adj[c]
            adj[best].discard(c)
            adj[best].discard(best)
            for e in adj[c]:
                if e != best:
                    adj[e].discard(c)
                    adj[e].add(best)
            alive[c] = False
            changed = True
    out = np.zeros_like(chart)
    for new_id, c in enumerate(np.nonzero(alive)[0]):
        out[members[c]] = new_id
    return out


def _absorb_small_charts(f: np.ndarray, chart: np.ndarray, nbr: np.ndarray,
                         min_faces: int = MIN_COALESCE_FACES) -> np.ndarray:
    """Sliver-chart cleanup (VERDICT r3 #8): cone-limited growing fragments
    thin features (plate rims, bevels) into dozens of 1-2-face charts whose
    boundaries dominate the seam length. Any chart under ``min_faces`` is
    absorbed into the adjacent chart sharing the most edges, normals
    notwithstanding — the parameterization stage's injectivity fixpoint
    re-splits a merge only if it actually overlaps, so this trades a
    bounded distortion increase for a large seam reduction (xatlas makes
    the same trade with its minimum chart area)."""
    if len(chart) < 64:
        # tiny inputs (the split-coalescer calls this once per offending
        # chart, thousands of times on fragmented meshes): pure python —
        # ~8 sweeps × ~10 numpy dispatches cost more than the work by ~50×.
        # Live list updates keep the original chain-absorption semantics.
        ch = [int(c) for c in chart]
        nb = [[int(d) for d in row] for row in nbr]
        for _ in range(8):
            sizes = {}
            for c in ch:
                sizes[c] = sizes.get(c, 0) + 1
            small = sorted(c for c, s in sizes.items() if s < min_faces)
            if not small:
                break
            small_set = set(small)
            moved = False
            for c in small:
                sel = [i for i, cc in enumerate(ch) if cc == c]
                if not sel:
                    continue
                votes = {}
                for i in sel:
                    for d in nb[i]:
                        if d >= 0 and ch[d] != c:
                            votes[ch[d]] = votes.get(ch[d], 0) + 1
                if not votes:
                    continue
                best = max(votes, key=lambda d: (d not in small_set, votes[d]))
                for i in sel:
                    ch[i] = best
                moved = True
            if not moved:
                break
        remap = {c: i for i, c in enumerate(sorted(set(ch)))}
        return np.fromiter((remap[c] for c in ch), np.int64, len(ch))
    chart = chart.copy()
    for _ in range(8):  # fixpoint: absorbing can re-expose small charts
        sizes = np.bincount(chart)
        small = np.nonzero(sizes < min_faces)[0]
        if len(small) == 0:
            break
        small_set = set(int(s) for s in small)
        # group faces by chart once per sweep (argsort) — per-chart
        # `chart == c` scans are O(F·n_small), which dominated fragmented
        # meshes (thousands of sliver charts). Absorptions INTO a pending
        # small chart append to its group so sweep-internal chains still
        # accrete into one band (the bevel-ring case) exactly like the
        # original live re-scan did
        order = np.argsort(chart, kind="stable")
        bounds = np.searchsorted(chart[order], np.arange(len(sizes) + 1))
        groups = {int(c): [order[bounds[c]:bounds[c + 1]]] for c in small}
        moved = False
        for c in small.tolist():
            parts = groups.pop(c, None)
            if not parts:
                continue
            sel = parts[0] if len(parts) == 1 else np.concatenate(parts)
            if len(sel) == 0:
                continue
            nb = nbr[sel].ravel()
            nb = nb[nb >= 0]
            ncharts = chart[nb]
            ncharts = ncharts[ncharts != c]
            if len(ncharts) == 0:
                continue  # isolated component: keep as its own chart
            cids, counts = np.unique(ncharts, return_counts=True)
            # prefer big neighbors; among them, the longest shared boundary
            is_big = np.fromiter((int(d) not in small_set for d in cids),
                                 np.int64, len(cids))
            score = is_big * (int(counts.max()) + 1) + counts
            best = int(cids[int(np.argmax(score))])
            chart[sel] = best
            if best in groups:
                groups[best].append(sel)
            moved = True
        if not moved:
            break
    _, chart = np.unique(chart, return_inverse=True)
    return chart


def _lscm(pts: np.ndarray, tris: np.ndarray):
    """Free-boundary least-squares conformal map (Lévy et al. 2002, the
    parameterization xatlas uses per chart). pts: [n,3], tris: [T,3] local
    indices. Returns [n,2] float64 uv, or None when the solve fails.

    Minimizes the Cauchy-Riemann residual over all triangles with two
    pinned vertices; sparse normal equations solved with SuperLU."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
    except Exception:  # pragma: no cover — scipy is in the image
        return None
    n = len(pts)
    if n < 3 or len(tris) < 1:
        return None

    # local orthonormal frame per triangle
    e1 = pts[tris[:, 1]] - pts[tris[:, 0]]
    e2 = pts[tris[:, 2]] - pts[tris[:, 0]]
    nrm = np.cross(e1, e2)
    a2 = np.linalg.norm(nrm, axis=1)                      # 2·area
    good = a2 > 1e-14
    xaxis = e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-14)
    yaxis = np.cross(nrm, xaxis)
    yaxis /= np.maximum(np.linalg.norm(yaxis, axis=1, keepdims=True), 1e-14)
    # local 2D coords: p0=(0,0), p1=(|e1|,0), p2=(e2·x, e2·y)
    x = np.zeros((len(tris), 3))
    y = np.zeros((len(tris), 3))
    x[:, 1] = np.einsum("td,td->t", e1, xaxis)
    x[:, 2] = np.einsum("td,td->t", e2, xaxis)
    y[:, 2] = np.einsum("td,td->t", e2, yaxis)
    # complex corner weights W_i = (p_k - p_j)/sqrt(2A), (i,j,k) cyclic
    s = 1.0 / np.sqrt(np.maximum(a2, 1e-14))
    s = np.where(good, s, 0.0)
    wr = np.stack([(x[:, 2] - x[:, 1]), (x[:, 0] - x[:, 2]),
                   (x[:, 1] - x[:, 0])], 1) * s[:, None]
    wi = np.stack([(y[:, 2] - y[:, 1]), (y[:, 0] - y[:, 2]),
                   (y[:, 1] - y[:, 0])], 1) * s[:, None]

    # pin the two vertices realizing the largest bbox extent
    ext_axis = np.argmax(pts.max(0) - pts.min(0))
    p0 = int(np.argmin(pts[:, ext_axis]))
    p1 = int(np.argmax(pts[:, ext_axis]))
    if p0 == p1:
        return None
    pinned = {p0: (0.0, 0.0), p1: (1.0, 0.0)}
    free = np.full(n, -1, np.int64)
    free_ids = [i for i in range(n) if i not in pinned]
    free[free_ids] = np.arange(len(free_ids))
    nf_ = len(free_ids)

    T = len(tris)
    rows, cols, vals = [], [], []
    b = np.zeros(2 * T)
    for corner in range(3):
        vtx = tris[:, corner]
        fidx = free[vtx]
        isfree = fidx >= 0
        rr = np.arange(T)
        # Re rows (t): +Wr·u − Wi·v ; Im rows (T+t): +Wi·u + Wr·v
        for (row_off, wu, wv) in ((0, wr[:, corner], -wi[:, corner]),
                                  (T, wi[:, corner], wr[:, corner])):
            rows.append(row_off + rr[isfree]); cols.append(fidx[isfree])
            vals.append(wu[isfree])
            rows.append(row_off + rr[isfree]); cols.append(nf_ + fidx[isfree])
            vals.append(wv[isfree])
        # pinned contributions → rhs
        for pv, (pu_, pv_) in pinned.items():
            m = vtx == pv
            if m.any():
                b[rr[m]] -= wr[m, corner] * pu_ - wi[m, corner] * pv_
                b[T + rr[m]] -= wi[m, corner] * pu_ + wr[m, corner] * pv_
    rows_c = np.concatenate(rows)
    cols_c = np.concatenate(cols)
    vals_c = np.concatenate(vals)
    if nf_ <= 192 and T <= 512:
        # small charts (the common case on charted production meshes —
        # thousands per mesh): dense normal equations beat scipy's sparse
        # assembly + SuperLU by ~10× at this size. Same linear system.
        Ad = np.zeros((2 * T, 2 * nf_))
        np.add.at(Ad, (rows_c, cols_c), vals_c)
        AtA_d = Ad.T @ Ad
        Atb_d = Ad.T @ b
        try:
            xsol = np.linalg.solve(AtA_d, Atb_d)
        except np.linalg.LinAlgError:
            # singular system (orphan vertex with only zero-area weights):
            # the sparse branch yields NaN → caller's planar fallback; keep
            # that semantics rather than accepting a min-norm solution
            return None
    else:
        A = sp.coo_matrix((vals_c, (rows_c, cols_c)),
                          shape=(2 * T, 2 * nf_)).tocsr()
        AtA = (A.T @ A).tocsc()
        Atb = A.T @ b
        try:
            xsol = spla.spsolve(AtA, Atb)
        except Exception:
            return None
    if not np.isfinite(xsol).all():
        return None
    uv = np.zeros((n, 2))
    uv[free >= 0, 0] = xsol[:nf_][free[free >= 0]]
    uv[free >= 0, 1] = xsol[nf_:][free[free >= 0]]
    uv[p0] = pinned[p0]
    uv[p1] = pinned[p1]
    return uv


def _arap_refine(pts: np.ndarray, tris: np.ndarray, uv0: np.ndarray,
                 iters: int = 4):
    """As-rigid-as-possible parameterization refinement (Liu et al. 2008,
    local/global): drives the per-triangle Jacobian toward a pure rotation,
    shrinking the area/stretch distortion a conformal (LSCM) map leaves on
    curved charts. The cotan Laplacian is factorized once and reused across
    iterations. Returns refined uv (float64) or None on failure."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
    except Exception:  # pragma: no cover
        return None
    n = len(pts)
    T = len(tris)
    if n < 4 or T < 2:
        return None
    # per-triangle local 2D reference coords
    e1 = pts[tris[:, 1]] - pts[tris[:, 0]]
    e2 = pts[tris[:, 2]] - pts[tris[:, 0]]
    nrm = np.cross(e1, e2)
    a2 = np.linalg.norm(nrm, axis=1)
    ok = a2 > 1e-14
    xax = e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-14)
    yax = np.cross(nrm, xax)
    yax /= np.maximum(np.linalg.norm(yax, axis=1, keepdims=True), 1e-14)
    P = np.zeros((T, 3, 2))
    P[:, 1, 0] = np.einsum("td,td->t", e1, xax)
    P[:, 2, 0] = np.einsum("td,td->t", e2, xax)
    P[:, 2, 1] = np.einsum("td,td->t", e2, yax)

    # cotangent weight of the corner OPPOSITE each edge (i->j spans corner k)
    cot = np.zeros((T, 3))
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        u_ = P[:, i] - P[:, k]
        w_ = P[:, j] - P[:, k]
        cr = u_[:, 0] * w_[:, 1] - u_[:, 1] * w_[:, 0]
        cot[:, k] = np.einsum("td,td->t", u_, w_) / np.maximum(
            np.abs(cr), 1e-14)
    cot = np.where(ok[:, None], np.clip(cot, -20.0, 20.0), 0.0)

    # Laplacian: edge (a,b) of triangle t (edge k spans corners k+1,k+2)
    # weighted by cot of the opposite corner k
    ea = np.concatenate([tris[:, (k + 1) % 3] for k in range(3)])
    eb = np.concatenate([tris[:, (k + 2) % 3] for k in range(3)])
    ew = np.concatenate([cot[:, k] for k in range(3)])
    rows = np.concatenate([ea, eb, ea, eb])
    cols = np.concatenate([eb, ea, ea, eb])
    vals = np.concatenate([-ew, -ew, ew, ew])
    # pin vertex 0 (fix gauge)
    freesel = np.arange(1, n)
    if n <= 256:
        # small charts: dense LU beats scipy's sparse factorization setup
        # by ~10× at this size (same Laplacian, same solves)
        import scipy.linalg as sla

        Ld = np.zeros((n, n))
        np.add.at(Ld, (rows, cols), vals)
        Lf0 = Ld[1:, :1]
        try:
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                lu = sla.lu_factor(Ld[1:, 1:])
        except Exception:
            return None
        if np.abs(np.diag(lu[0])).min() < 1e-12:
            # singular Laplacian (disconnected chart) — the sparse
            # factorization raises here; keep that failure semantics
            return None
        solve = functools.partial(sla.lu_solve, lu)
    else:
        L = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        Lff = L[freesel][:, freesel].tocsc()
        Lf0 = L[freesel][:, [0]]
        try:
            solve = spla.factorized(Lff)
        except Exception:
            return None

    uv = uv0.copy()
    for _ in range(iters):
        # local: best rotation per triangle (closed-form 2x2 polar)
        q1 = uv[tris[:, 1]] - uv[tris[:, 0]]
        q2 = uv[tris[:, 2]] - uv[tris[:, 0]]
        # J = [q1 q2] @ inv([p1 p2]) with p1=P[:,1], p2=P[:,2] (p0=0)
        p1, p2 = P[:, 1], P[:, 2]
        det = p1[:, 0] * p2[:, 1] - p1[:, 1] * p2[:, 0]
        det = np.where(np.abs(det) < 1e-14, 1e-14, det)
        inv00, inv01 = p2[:, 1] / det, -p2[:, 0] / det
        inv10, inv11 = -p1[:, 1] / det, p1[:, 0] / det
        Ja = q1[:, 0] * inv00 + q2[:, 0] * inv10
        Jb = q1[:, 0] * inv01 + q2[:, 0] * inv11
        Jc = q1[:, 1] * inv00 + q2[:, 1] * inv10
        Jd = q1[:, 1] * inv01 + q2[:, 1] * inv11
        th = np.arctan2(Jc - Jb, Ja + Jd)
        cth, sth = np.cos(th), np.sin(th)

        # global: rhs_i = Σ_edges cot * R_t (p_i - p_j)
        rhs = np.zeros((n, 2))
        for k in range(3):
            a_, b_ = (k + 1) % 3, (k + 2) % 3
            dp = P[:, a_] - P[:, b_]
            rx = cth * dp[:, 0] - sth * dp[:, 1]
            ry = sth * dp[:, 0] + cth * dp[:, 1]
            w_ = cot[:, k]
            np.add.at(rhs, tris[:, a_],
                      np.stack([w_ * rx, w_ * ry], 1))
            np.add.at(rhs, tris[:, b_],
                      np.stack([-w_ * rx, -w_ * ry], 1))
        b_f = rhs[freesel] - Lf0 @ uv[[0]]
        try:
            uv[freesel, 0] = solve(b_f[:, 0])
            uv[freesel, 1] = solve(b_f[:, 1])
        except Exception:
            return None
    if not np.isfinite(uv).all():
        return None
    return uv


def _flip_fraction(uv: np.ndarray, tris: np.ndarray) -> float:
    """Fraction of UV triangles whose orientation disagrees with the
    majority (0 for an injective flattening)."""
    a = uv[tris[:, 1]] - uv[tris[:, 0]]
    b = uv[tris[:, 2]] - uv[tris[:, 0]]
    s = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    pos = float((s > 0).sum())
    neg = float((s < 0).sum())
    tot = max(pos + neg, 1.0)
    return min(pos, neg) / tot


def _coalesce_split(f_sel: np.ndarray, sub: np.ndarray, sel: np.ndarray,
                    nbr: np.ndarray,
                    min_faces: int = MIN_COALESCE_FACES) -> np.ndarray:
    """Absorb tiny pieces of an in-chart split into their larger siblings
    (bevel rings straddling two projection axes otherwise shatter into
    1-face shards — the VERDICT r3 #8 'chart splitting casualty')."""
    g2l = np.full(nbr.shape[0], -1, np.int64)
    g2l[sel] = np.arange(len(sel))
    local_nbr = g2l[np.maximum(nbr[sel], 0)]
    local_nbr[nbr[sel] < 0] = -1
    return _absorb_small_charts(f_sel, sub, local_nbr, min_faces)


def _tiny_planar_param(sel, vl, fl, fnl, areal):
    """Pure-python planar parameterization of a 1-2 face chart — identical
    math to the numpy branch in _parameterize_charts (area-weighted normal →
    _chart_basis projection → 3D-area scale normalization), without its ~15
    per-chart numpy dispatches."""
    from math import sqrt

    nx = ny = nz = 0.0
    a3 = 0.0
    for s in sel:
        a = areal[s]
        gx, gy, gz = fnl[s]
        nx += gx * a
        ny += gy * a
        nz += gz * a
        a3 += a
    ln = max(sqrt(nx * nx + ny * ny + nz * nz), 1e-12)
    nx, ny, nz = nx / ln, ny / ln, nz / ln
    (ux, uy, uz), (wx, wy, wz) = _basis_scalar(nx, ny, nz)

    vid = sorted({k for s in sel for k in fl[s]})
    row = {g: i for i, g in enumerate(vid)}
    uvc = []
    for g in vid:
        px, py, pz = vl[g]
        uvc.append([px * ux + py * uy + pz * uz,
                    px * wx + py * wy + pz * wz])
    auv = 0.0
    for s in sel:
        i0, i1, i2 = (row[k] for k in fl[s])
        e1u = uvc[i1][0] - uvc[i0][0]
        e1v = uvc[i1][1] - uvc[i0][1]
        e2u = uvc[i2][0] - uvc[i0][0]
        e2v = uvc[i2][1] - uvc[i0][1]
        auv += abs(e1u * e2v - e1v * e2u)
    auv *= 0.5
    uv = np.asarray(uvc, np.float64)
    if auv > 1e-14:
        uv = uv * sqrt(a3 / auv)
    return np.asarray(vid, np.int64), uv


def _parameterize_charts(v: np.ndarray, f: np.ndarray, fn: np.ndarray,
                         chart: np.ndarray, min_lscm_faces: int = 20,
                         thresh: float = 1.12, nbr_g: np.ndarray = None):
    """Per-chart parameterization with an injectivity fixpoint: LSCM for
    charts of ≥ min_lscm_faces (planar projection otherwise or on LSCM
    failure), overlap-checked via the rasterized area ratio; overlapping
    charts are split (6-axis bucketing with shard coalescing, then spatial
    median) and requeued.
    Returns (chart ids, {chart: (global vertex ids, local uv)})."""
    if nbr_g is None:
        nbr_g = _face_adjacency(f, len(v))
    chart = chart.copy()
    fa = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    areas = np.linalg.norm(fa, axis=1) * 0.5
    centroids = (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3.0
    # group faces by chart ONCE (argsort) and carry each chart's face-index
    # array through the queue — per-pop `chart == c` scans are O(F·n_charts),
    # which dominated fragmented meshes (thousands of 1-4 face charts)
    n0 = int(chart.max()) + 1
    order_ = np.argsort(chart, kind="stable")
    bounds_ = np.searchsorted(chart[order_], np.arange(n0 + 1))
    queue = [(c, order_[bounds_[c]:bounds_[c + 1]]) for c in range(n0)]
    next_id = n0
    params = {}
    # pure-python fast path for 1-2 face charts (accepted unconditionally,
    # planar projection): fragmented meshes produce thousands, and ~15 numpy
    # dispatches per chart cost more than the arithmetic by ~50×
    _lists = None
    while queue:
        c, sel = queue.pop()
        if len(sel) == 0:
            continue
        if len(sel) <= 2:
            if _lists is None:
                _lists = (v.tolist(), f.tolist(), fn.tolist(), areas.tolist())
            params[c] = _tiny_planar_param(sel.tolist(), *_lists)
            continue
        tris = f[sel]
        vid, local = np.unique(tris.reshape(-1), return_inverse=True)
        ltris = local.reshape(-1, 3).astype(np.int64)
        uvc = None
        if len(sel) >= min_lscm_faces:
            uvc = _lscm(v[vid], ltris)
            if uvc is not None and _flip_fraction(uvc, ltris) > 0.01:
                uvc = None
            elif uvc is not None:
                refined = _arap_refine(v[vid], ltris, uvc)
                if refined is not None and (
                        _flip_fraction(refined, ltris)
                        <= max(_flip_fraction(uvc, ltris), 0.002)):
                    uvc = refined
        if uvc is None:
            n_c = (fn[sel] * areas[sel, None]).sum(0)
            n_c /= max(np.linalg.norm(n_c), 1e-12)
            bu, bw = _chart_basis(n_c)
            uvc = np.stack([v[vid] @ bu, v[vid] @ bw], axis=1)
        # (1-2 face charts were consumed by the tiny fast path above, so
        # every chart reaching here takes the overlap check)
        if _chart_overlap_ratio(uvc, ltris) <= thresh:
            # normalize the chart's global scale to its 3D area so the
            # shelf packer allocates texture area ∝ surface area
            a = uvc[ltris[:, 1]] - uvc[ltris[:, 0]]
            b = uvc[ltris[:, 2]] - uvc[ltris[:, 0]]
            auv = float(np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]).sum()) / 2
            a3 = float(areas[sel].sum())
            if auv > 1e-14:
                uvc = uvc * np.sqrt(a3 / auv)
            params[c] = (vid, uvc)
            continue
        # split the chart and requeue the pieces (tiny shards of the split
        # are coalesced into their larger siblings first). For charts of
        # ≤ the coalescer's min_faces the bucket split is a guaranteed
        # no-op (every piece would be absorbed back), so skip straight to
        # the median split — fragmented meshes hit this thousands of times
        if len(sel) > MIN_COALESCE_FACES:
            bucket = np.argmax(fn[sel] @ _AXES.T, axis=1)
            sub = _face_components_in_bucket(tris, bucket, len(v))
            if sub.max() > 0:
                sub = _coalesce_split(tris, sub, sel, nbr_g)
        else:
            sub = np.zeros(len(sel), np.int64)
        if sub.max() == 0:
            cen = centroids[sel]
            axis = np.argmax(cen.max(0) - cen.min(0))
            sub = (cen[:, axis] > np.median(cen[:, axis])).astype(np.int64)
            if sub.max() == 0 or sub.min() == 1:
                # degenerate, cannot split further: accept as-is
                params[c] = (vid, uvc)
                continue
        for s_ in range(1, int(sub.max()) + 1):
            sel_s = sel[sub == s_]
            chart[sel_s] = next_id
            queue.append((next_id, sel_s))
            next_id += 1
        queue.append((c, sel[sub == 0]))
    return chart, params


def unwrap(vertices: np.ndarray, faces: np.ndarray, margin: float = 0.004,
           method: str = "grow"):
    """→ (new_vertices, new_faces, uv, vmapping): vertices split per chart.

    method='grow' (default): region-growing charts + average-normal
    projection with an overlap guard. method='axis': the original 6-axis
    bucketing (also the per-chart fallback when a grown chart overlaps)."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    fnl = np.linalg.norm(fn, axis=1, keepdims=True)
    areas = (fnl[:, 0] * 0.5).astype(np.float64)
    fn = fn / np.maximum(fnl, 1e-12)
    nbr = _face_adjacency(f, len(v))

    if method == "grow":
        chart = _grow_charts(fn, areas, nbr)
        # boundary smoothing can strand disconnected islands under one id;
        # every chart must be edge-connected for packing and the guard
        chart = _face_components_in_bucket(f, chart, len(v))
        chart = _merge_charts(fn, areas, f, chart, nbr)
        chart = _absorb_small_charts(f, chart, nbr)
    else:
        bucket = np.argmax(fn @ _AXES.T, axis=1)            # [F]
        bucket = _smooth_buckets(fn, bucket, nbr)
        chart = _face_components_in_bucket(f, bucket, len(v))

    # per-chart parameterization (LSCM with planar fallback) + injectivity
    # fixpoint — overlapping charts are split and re-parameterized
    chart, params = _parameterize_charts(v, f, fn, chart, nbr_g=nbr)
    n_charts = chart.max() + 1

    # split vertices per (vertex, chart)
    corner_v = f.reshape(-1)
    corner_chart = np.repeat(chart, 3)
    pair = corner_v * np.int64(n_charts) + corner_chart
    uniq_pair, new_idx = np.unique(pair, return_inverse=True)
    new_faces = new_idx.reshape(-1, 3).astype(np.int32)
    src_vertex = (uniq_pair // n_charts).astype(np.int64)
    src_chart = (uniq_pair % n_charts).astype(np.int64)
    new_vertices = v[src_vertex]

    # group split vertices by chart once (argsort): per-chart boolean masks
    # are O(N·n_charts), which dominated fragmented meshes
    uv2 = np.zeros((len(new_vertices), 2), np.float64)
    sizes = np.zeros((n_charts, 2))
    mins = np.zeros((n_charts, 2))
    gorder = np.argsort(src_chart, kind="stable")
    gbounds = np.searchsorted(src_chart[gorder], np.arange(n_charts + 1))
    # per-chart triangle footprints (local uv + local tris) for the raster
    # packer; only built when the chart count makes raster packing viable
    build_fp = n_charts <= RASTER_MAX_CHARTS
    footprints = [None] * n_charts if build_fp else None
    forder = np.argsort(chart, kind="stable")
    fbounds = np.searchsorted(chart[forder], np.arange(n_charts + 1))
    for c in range(n_charts):
        sel = gorder[gbounds[c]:gbounds[c + 1]]
        if len(sel) == 0:
            continue
        vid, uvc = params[c]
        # map the split vertices' source ids into the chart's local rows
        loc = np.searchsorted(vid, src_vertex[sel])
        u = uvc[loc]
        uv2[sel] = u
        lo = u.min(0)
        hi = u.max(0)
        mins[c] = lo
        sizes[c] = np.maximum(hi - lo, 1e-9)
        if build_fp:
            fsel = forder[fbounds[c]:fbounds[c + 1]]
            ftris = np.searchsorted(vid, f[fsel].reshape(-1)).reshape(-1, 3)
            footprints[c] = (uvc - lo, ftris)

    pos, scale, rot = _pack_charts(sizes, margin, footprints)
    loc = uv2 - mins[src_chart]
    r = rot[src_chart]
    # 90° rotation (u,v) → (h−v, u): det +1, no mirroring
    lu = np.where(r, sizes[src_chart, 1] - loc[:, 1], loc[:, 0])
    lv = np.where(r, loc[:, 0], loc[:, 1])
    uv = np.stack([lu, lv], axis=1) * scale + pos[src_chart]
    return (new_vertices.astype(np.float32), new_faces,
            uv.astype(np.float32), src_vertex)


def mesh_uv_wrap(mesh: Mesh, max_faces: int = 500000000) -> Mesh:
    """Parity API (uv_warp_utils.py:19-33): returns a mesh with remapped
    vertices/faces and ``mesh.uv`` set."""
    if isinstance(mesh, (list, tuple)):
        mesh = mesh[0]
    if len(mesh.faces) > max_faces:
        raise ValueError("The mesh has more than 500,000,000 faces, which is not supported.")
    if mesh.uv is not None:
        return mesh
    nv, nf, uv, _ = unwrap(mesh.vertices, mesh.faces)
    return Mesh(nv, nf, uv=uv)
