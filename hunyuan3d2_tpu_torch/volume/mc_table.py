"""Classic marching-cubes case table, GENERATED (not transcribed); a copy of
hunyuan3d2_tpu/volume/mc_table.py (the port imports nothing of the JAX
package).

Parity target: the reference's 'mc' surface extractor
(hy3dgen/shapegen/models/autoencoders/surface_extractors.py:67-76) runs
``skimage.measure.marching_cubes`` — classic MC topology: vertices only on
cube edges, ≤5 triangles per cell. Neither skimage nor any MC table ships in
this image, so the 256-entry triangle table is derived at import time from
first principles:

1. For each of the 256 corner sign configurations, polygonize the cube with
   marching tetrahedra over the 6 Kuhn tetrahedra (a face-to-face tiling —
   crack-free), with intersections at edge midpoints. MT vertices live on
   cube edges (ids 0-11), face diagonals (12-17) and the main diagonal (18).
2. Each connected isosurface patch inside the cube is a topological disk.
   Its boundary cycle (edges of the patch lying on cube faces) alternates
   cube-edge and face-diagonal vertices; dropping the interior
   (diagonal/face) vertices leaves the classic MC boundary polygon of
   cube-edge vertices.
3. Fan-triangulate each boundary polygon, preserving the MT orientation
   (outward normals, inside = value > level).

Face connectivity on ambiguous faces follows the fixed face diagonal of the
Kuhn tiling — the same resolution for the two cells sharing a face, so the
output is watertight (the same guarantee skimage gets from the asymptotic
decider, with a different but equally consistent convention).

The construction is validated at import: every patch must be a single
boundary cycle, and every non-trivial case must triangulate. A unit test
further checks watertightness and MC-scale face counts on analytic SDFs
(tests/test_surface.py; the copy is held to the original by
tests/test_torch_surface.py).
"""

from __future__ import annotations

import numpy as np

# cube corners (standard MC numbering, main diagonal 0→6)
CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64)

# cube edges as corner pairs — ids 0-11 (the classic MC edge numbering)
CUBE_EDGES = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 0],
     [4, 5], [5, 6], [6, 7], [7, 4],
     [0, 4], [1, 5], [2, 6], [3, 7]], dtype=np.int64)

# Kuhn decomposition: 6 tets sharing the 0-6 diagonal
_TETS = np.array(
    [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
     [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], dtype=np.int64)

_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                      dtype=np.int64)


def _build_table():
    # corner-pair (sorted) → cube edge id; pairs not in CUBE_EDGES are
    # diagonals (face or main) — interior vertices to be collapsed
    edge_of_pair = {}
    for e, (a, b) in enumerate(CUBE_EDGES):
        edge_of_pair[(min(a, b), max(a, b))] = e

    # per-tet case table (same logic as volume/surface.py, kept local so the
    # generator is self-contained)
    def tet_tris(inside4):
        case = sum(1 << i for i in range(4) if inside4[i])
        if case in (0, 15):
            return []
        ins = [i for i in range(4) if inside4[i]]
        outs = [i for i in range(4) if not inside4[i]]

        def eid(i, j):
            for e, (a, b) in enumerate(_TET_EDGES):
                if {a, b} == {i, j}:
                    return e
            raise AssertionError

        if len(ins) == 1:
            i = ins[0]
            return [[eid(i, o) for o in outs]]
        if len(ins) == 3:
            o = outs[0]
            return [[eid(i, o) for i in ins]]
        i1, i2 = ins
        o1, o2 = outs
        q = [eid(i1, o1), eid(i1, o2), eid(i2, o2), eid(i2, o1)]
        return [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]

    case_tris = {}
    ntri = np.zeros(256, dtype=np.int64)
    corners_f = CORNERS.astype(np.float64)

    for case in range(1, 255):
        inside = [(case >> i) & 1 == 1 for i in range(8)]
        # 1. MT polygonization with midpoint intersections; vertices keyed by
        #    their (sorted) cube-corner pair
        tris = []  # list of [pair, pair, pair] with outward orientation
        for tet in _TETS:
            ins4 = [inside[c] for c in tet]
            for tri in tet_tris(ins4):
                pairs = []
                for e in tri:
                    a, b = _TET_EDGES[e]
                    ca, cb = tet[a], tet[b]
                    pairs.append((min(ca, cb), max(ca, cb)))
                # orient: normal points from inside toward outside
                p = [(corners_f[a] + corners_f[b]) / 2 for a, b in pairs]
                n = np.cross(p[1] - p[0], p[2] - p[0])
                cin = np.mean([corners_f[c] for c in tet if inside[c]], axis=0)
                cout = np.mean([corners_f[c] for c in tet if not inside[c]], axis=0)
                if np.dot(n, cout - cin) < 0:
                    pairs = [pairs[0], pairs[2], pairs[1]]
                if len(set(pairs)) == 3:
                    tris.append(pairs)

        # 2. connected components of the patch graph (shared vertices)
        parent = {}

        def find(x):
            while parent.get(x, x) != x:
                parent[x] = parent.get(parent[x], parent[x])
                x = parent[x]
            return x

        def union(x, y):
            parent.setdefault(x, x)
            parent.setdefault(y, y)
            rx, ry = find(x), find(y)
            if rx != ry:
                parent[rx] = ry

        for t in tris:
            union(t[0], t[1])
            union(t[1], t[2])
        comps = {}
        for t in tris:
            comps.setdefault(find(t[0]), []).append(t)

        out_tris = []
        for comp in comps.values():
            # 3. boundary half-edges: directed edges appearing once
            count = {}
            for t in comp:
                for i in range(3):
                    a, b = t[i], t[(i + 1) % 3]
                    count[(a, b)] = count.get((a, b), 0) + 1
            boundary = {a: b for (a, b), c in count.items()
                        if c == 1 and count.get((b, a), 0) == 0}
            assert boundary, f"case {case}: closed patch inside a cube"
            # walk ALL boundary cycles; a patch that is an annulus (e.g. the
            # two main-diagonal corners inside, case 65 — MT connects them
            # with a tube through the cube interior) contributes one disk per
            # cycle, which is exactly classic MC's resolution (two separate
            # corner cuts). Watertight either way: the boundary on the cube
            # faces is identical.
            while boundary:
                start = next(iter(boundary))
                cycle = [start]
                cur = boundary.pop(start)
                while cur != start:
                    cycle.append(cur)
                    cur = boundary.pop(cur)
                # keep only cube-edge vertices (drop face-diagonal ones)
                poly = [edge_of_pair[p] for p in cycle if p in edge_of_pair]
                assert len(poly) >= 3, \
                    f"case {case}: degenerate boundary {cycle}"
                # boundary walk direction: MT triangles are CCW seen from
                # outside, so their boundary (once-only directed edges) runs
                # CCW seen from outside as well — fan keeps that orientation
                for i in range(1, len(poly) - 1):
                    out_tris.append([poly[0], poly[i], poly[i + 1]])

        assert out_tris, f"case {case}: no triangles"
        ntri[case] = len(out_tris)
        case_tris[case] = out_tris

    # table width = worst case (corners connected across face diagonals by
    # the Kuhn convention can merge patches, so some cases exceed classic
    # MC's 5 triangles; the fan count stays cycle_len-2 per patch)
    width = int(ntri.max())
    tri_table = -np.ones((256, width, 3), dtype=np.int64)
    for case, tris in case_tris.items():
        tri_table[case, :len(tris)] = tris
    return tri_table, ntri


TRI_TABLE, NTRI = _build_table()
