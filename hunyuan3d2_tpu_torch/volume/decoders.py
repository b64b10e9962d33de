"""Latent → occupancy grid decoding and on-device surface nets (port of the
FlashVDM path of hunyuan3d2_tpu/volume/decoders.py).

Block-sparse, fixed-capacity decoding: a dense coarse pass at the fine
lattice's block corners marks near-surface blocks, a fixed number of them
(the capacity) is chosen by score and decoded densely, and the result is
scattered over the trilinearly upsampled coarse grid. Every buffer has a
static size, as in the JAX package, so logits and meshes compare directly.

Two details keep the port's choices identical to the JAX package's:
  * block choice: ``jax.lax.top_k`` breaks ties by the lowest index and
    ``torch.topk`` does not, so blocks are chosen by a stable descending
    sort (:func:`stable_topk`);
  * ``mode="drop"`` scatters write into ``capacity + 1`` rows whose last row
    is a spill slot, sliced off afterwards; only the spill slot receives
    repeated indices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hunyuan3d2_tpu_torch.utils import timer


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_coords_from_flat(flat_idx: torch.Tensor, res: int, box_v: float) -> torch.Tensor:
    """Flat indices in [0, res³) → xyz [.., 3] fp32 on a res³ lattice over
    [-box_v, box_v] (x-major, 'ij' indexing)."""
    step = 2.0 * box_v / (res - 1)
    xyz = torch.stack([flat_idx // (res * res), (flat_idx // res) % res, flat_idx % res], -1)
    return xyz.float() * step - box_v


class VanillaVolumeDecoder:
    """Dense decode of all (res+1)³ lattice points in chunks of
    ``num_chunks`` (the tail chunk padded with the last point)."""

    def __call__(self, decode_fn, batch_size: int, octree_resolution: int,
                 num_chunks: int = 65536, box_v: float = 1.01, device=None,
                 **kwargs) -> torch.Tensor:
        """``decode_fn`` maps [B, P, 3] fp32 points to [B, P] logits →
        [B, res, res, res] fp32."""
        res = octree_resolution + 1
        total = res ** 3
        chunk = min(num_chunks, total)
        logits = []
        for start in range(0, _cdiv(total, chunk) * chunk, chunk):
            flat = (start + torch.arange(chunk, device=device)).clamp(max=total - 1)
            pts = grid_coords_from_flat(flat, res, box_v).expand(batch_size, chunk, 3)
            logits.append(decode_fn(pts).float())
        return torch.cat(logits, 1)[:, :total].reshape(batch_size, res, res, res)


def stable_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, ties broken by
    the lowest index (``jax.lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def _active_mask(g: torch.Tensor, level: float) -> torch.Tensor:
    """[R, R, R] grid → bool [R-1]³: the cells whose 8 corners straddle
    ``level``."""
    occ = g > level
    nc = g.shape[0] - 1
    base = occ[:-1, :-1, :-1]
    agree = torch.ones_like(base)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                if dx == dy == dz == 0:
                    continue
                agree &= occ[dx:nc + dx, dy:nc + dy, dz:nc + dz] == base
    return ~agree


def _near_surface_blocks(coarse: torch.Tensor, level: float) -> torch.Tensor:
    """[r, r, r] coarse grid → bool mask over the (r-1)³ cells: corners
    disagree in sign, dilated by one cell (3³ max-pool)."""
    near = _active_mask(coarse, level).float()[None, None]
    return F.max_pool3d(near, 3, stride=1, padding=1)[0, 0] > 0


class HierarchicalVolumeDecoding:
    """Coarse → fine block-sparse decoding with a fixed block budget."""

    def __init__(self, block: int = 8, capacity_frac: float = 0.12, coarse_factor: int = 2):
        self.block = block
        self.capacity_frac = capacity_frac
        self.coarse_factor = coarse_factor

    def decode_sparse(self, decode_fn, batch_size: int, octree_resolution: int,
                      num_chunks: int = 65536, box_v: float = 1.01, mc_level: float = 0.0,
                      device=None):
        """Returns (coarse [ncp]³ f16, blk_idx [k] int64 ascending,
        fine_vals [k, block³] f16). ``decode_fn`` maps [1, P, 3] fp32 points
        to [1, P] logits."""
        if batch_size != 1:
            raise ValueError("hierarchical decode is per mesh (batch_size=1)")
        res = octree_resolution + 1
        block, cf = self.block, self.coarse_factor
        if block % cf:
            raise ValueError("coarse_factor must divide block")
        s = block // cf
        nb = _cdiv(res, block)
        step = 2.0 * box_v / (res - 1)

        # coarse pass aligned to the fine lattice: coarse point i sits at fine
        # index i*s (clamped), so refined blocks and the background share the
        # zero crossing exactly at coarse points
        ncp = nb * cf + 1
        cflat = torch.arange(ncp ** 3, device=device)
        cidx = torch.stack([cflat // (ncp * ncp), (cflat // ncp) % ncp, cflat % ncp], -1) * s
        cpts = cidx.clamp(max=res - 1).float() * step - box_v
        chunk = min(num_chunks, ncp ** 3)
        n_cchunks = _cdiv(ncp ** 3, chunk)
        cpts = F.pad(cpts, (0, 0, 0, n_cchunks * chunk - ncp ** 3))
        cvals = torch.cat([decode_fn(p[None]).float()[0]
                           for p in cpts.reshape(n_cchunks, chunk, 3)])
        coarse = cvals[:ncp ** 3].reshape(ncp, ncp, ncp)

        near = _near_surface_blocks(coarse, mc_level)
        score = near.float().reshape(nb, cf, nb, cf, nb, cf).sum(dim=(1, 3, 5)).reshape(-1)
        k = max(1, min(int(nb ** 3 * self.capacity_frac), nb ** 3))
        blk_idx = torch.sort(stable_topk(score, k)).values
        # the queries this decode needs: the coarse points and the chosen blocks'
        timer.add("Volume Decoding/queries_needed", ncp ** 3 + k * block ** 3)

        loc = torch.arange(block, device=device)
        lx, ly, lz = torch.meshgrid(loc, loc, loc, indexing="ij")
        loff = torch.stack([lx, ly, lz], -1).reshape(-1, 3)
        origins = torch.stack([blk_idx // (nb * nb), (blk_idx // nb) % nb, blk_idx % nb], -1)
        idx3 = (origins[:, None, :] * block + loff[None]).clamp(max=res - 1)
        pts = idx3.float() * step - box_v                          # [k, block³, 3]

        blocks_per_chunk = max(1, num_chunks // block ** 3)
        n_chunks = _cdiv(k, blocks_per_chunk)
        pts = F.pad(pts, (0, 0, 0, 0, 0, n_chunks * blocks_per_chunk - k))
        pts = pts.reshape(n_chunks, blocks_per_chunk * block ** 3, 3)
        fine = torch.cat([decode_fn(p[None]).float()[0] for p in pts])
        fine = fine.reshape(-1, block ** 3)[:k]
        return coarse.half(), blk_idx, fine.half()

    def __call__(self, decode_fn, batch_size: int, octree_resolution: int,
                 num_chunks: int = 65536, box_v: float = 1.01, mc_level: float = 0.0,
                 device=None) -> torch.Tensor:
        """Dense [1, res, res, res] fp32 logits."""
        return self.densify(*self.decode_sparse(decode_fn, batch_size, octree_resolution,
                                                num_chunks, box_v, mc_level, device),
                            octree_resolution)

    def densify(self, coarse16: torch.Tensor, blk_idx: torch.Tensor, fine16: torch.Tensor,
                octree_resolution: int) -> torch.Tensor:
        """:meth:`decode_sparse`'s output → the dense [1, res, res, res] fp32
        grid on its device: the refined blocks over the coarse grid's exact
        aligned trilinear upsampling."""
        coarse, fine = coarse16.float(), fine16.float()
        dev = coarse.device
        res = octree_resolution + 1
        block, cf = self.block, self.coarse_factor
        s = block // cf
        nb = _cdiv(res, block)
        res_pad = nb * block
        ncp = nb * cf + 1

        f_idx = torch.arange(res_pad, device=dev)
        c0 = (f_idx // s).clamp(max=ncp - 2)
        frac = (f_idx - c0 * s).float() / s

        def lerp_axis(arr, axis):
            a0 = arr.index_select(axis, c0)
            a1 = arr.index_select(axis, c0 + 1)
            shape = [1, 1, 1]
            shape[axis] = res_pad
            fr = frac.reshape(shape)
            return a0 * (1.0 - fr) + a1 * fr

        bg = lerp_axis(lerp_axis(lerp_axis(coarse, 0), 1), 2)
        grid = bg.reshape(nb, block, nb, block, nb, block).permute(0, 2, 4, 1, 3, 5)
        grid = grid.reshape(nb ** 3, block ** 3)
        grid[blk_idx] = fine
        grid = grid.reshape(nb, nb, nb, block, block, block).permute(0, 3, 1, 4, 2, 5)
        return grid.reshape(res_pad, res_pad, res_pad)[None, :res, :res, :res]


class FlashVDMVolumeDecoding(HierarchicalVolumeDecoding):
    """The FlashVDM speed profile: one coarse sample per block corner and a
    tighter block budget. It carries ``topk_mode`` ('mean' or 'merge'), the
    K/V pruning mode of the pruned decode (models/shapevae.py
    ``decode_queries_pruned``), which runs only where the VAE chooses it."""

    def __init__(self, topk_mode: str = "mean", block: int = 8, capacity_frac: float = 0.06,
                 coarse_factor: int = 1):
        if topk_mode not in ("mean", "merge"):
            raise ValueError(f"topk_mode must be 'mean' or 'merge', got {topk_mode!r}")
        super().__init__(block=block, capacity_frac=capacity_frac, coarse_factor=coarse_factor)
        self.topk_mode = topk_mode


def compact_rows(valid: torch.Tensor, rows: torch.Tensor, capacity: int, fill):
    """Stable fixed-capacity compaction: rows[i] for valid[i], in order, into
    a [capacity, ...] buffer. Returns (buf, count)."""
    v = valid.to(torch.int64)
    count = v.sum()
    pos = torch.cumsum(v, 0) - 1
    dest = torch.where(valid & (pos < capacity), pos, capacity)
    buf = torch.full((capacity + 1,) + tuple(rows.shape[1:]), fill, dtype=rows.dtype,
                     device=rows.device)
    buf[dest] = rows
    return buf[:capacity], count


_CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
_CUBE_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
               (0, 4), (1, 5), (2, 6), (3, 7))


def _sn_vertices(cells: torch.Tensor, v: torch.Tensor, level: float, R: int,
                 box_v: float) -> torch.Tensor:
    """Surface nets' vertices: cells [cap, 3] with corner values v [cap, 8]
    (fp32, _CORNERS order) → one vertex per cell, the mean of its cube-edge
    crossings, in bbox coords [cap, 3]; smooth in ``v``."""
    dev = cells.device
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=dev)
    edges = torch.tensor(_CUBE_EDGES, dtype=torch.int64, device=dev)
    va, vb = v[:, edges[:, 0]], v[:, edges[:, 1]]
    cross = (va > level) != (vb > level)
    denom = torch.where((vb - va).abs() < 1e-12, torch.full_like(va, 1e-12), vb - va)
    t = ((level - va) / denom).clamp(0.0, 1.0)
    pa = corners[edges[:, 0]].float()
    pb = corners[edges[:, 1]].float()
    pts = pa[None] + t[..., None] * (pb - pa)[None]
    w = cross.float()
    local = (pts * w[..., None]).sum(1) / w.sum(1, keepdim=True).clamp(min=1.0)
    return (cells.float() + local) / (R - 1.0) * (2.0 * box_v) - box_v


def _sn_quads(cells: torch.Tensor, cf: torch.Tensor, v: torch.Tensor, pad: torch.Tensor,
              lookup, nc: int, level: float):
    """Surface nets' quads: each active cell owns its three min-corner
    lattice edges (+x: corner 0→1, +y: 0→3, +z: 0→4) and emits a quad across
    each edge whose ends differ in sign, over itself and its three
    neighbours (``lookup`` maps flat cell ids to compacted positions; only
    interior cells use it), wound outward (inside > level). Returns (quads
    [3·cap, 4] int32, valid [3·cap] bool)."""
    strides = (nc * nc, nc, 1)
    occ0 = v[:, 0] > level
    end_corner = (1, 3, 4)
    me = torch.arange(cf.shape[0], dtype=torch.int32, device=cf.device)
    quads, valids = [], []
    for d in range(3):
        u, vv = (d + 1) % 3, (d + 2) % 3
        change = occ0 != (v[:, end_corner[d]] > level)
        interior = (cells[:, u] > 0) & (cells[:, vv] > 0)
        su, sv = strides[u], strides[vv]
        n1, n2, n3 = lookup(cf - su), lookup(cf - su - sv), lookup(cf - sv)
        q = torch.stack([me, n1, n2, n3], dim=1)
        quads.append(torch.where(occ0[:, None], q, q.flip(1)))
        valids.append(change & interior & ~pad & (n1 >= 0) & (n2 >= 0) & (n3 >= 0))
    return torch.cat(quads), torch.cat(valids)


def extract_active_cells(grid: torch.Tensor, level: float, capacity: int):
    """Active-cell compaction on the grid's device: the cells whose corners
    straddle ``level``, in ascending flat-id order, into a fixed capacity.
    grid [1, R, R, R] or [R, R, R] → (cell_flat [capacity] int32 with -1
    padding, corner_vals [capacity, 8] f16 in _CORNERS order (a padding
    row holds cell 0's corners), count = the number of active cells)."""
    g = grid[0] if grid.dim() == 4 else grid
    R = g.shape[0]
    nc = R - 1
    active = _active_mask(g, level).reshape(-1)
    ids = torch.arange(nc ** 3, dtype=torch.int32, device=g.device)
    cell_flat, count = compact_rows(active, ids, capacity, -1)
    safe = cell_flat.clamp(min=0).long()
    cells = torch.stack([safe // (nc * nc), (safe // nc) % nc, safe % nc], dim=1)
    cc = cells[:, None, :] + torch.tensor(_CORNERS, dtype=torch.int64, device=g.device)[None]
    pflat = (cc[..., 0] * R + cc[..., 1]) * R + cc[..., 2]
    return cell_flat, g.reshape(-1)[pflat].half(), count


def surface_nets_device(cell_flat: torch.Tensor, vals: torch.Tensor, R: int, level: float,
                        box_v: float, face_capacity: int):
    """Surface nets on the device from compacted active cells (port of JAX
    volume/decoders.py:298), differentiable in ``vals``.

    cell_flat [cap] int32 ascending flat cell ids (-1 padding), vals
    [cap, 8] corner values (f16 from :func:`extract_active_cells`) in
    _CORNERS order → (verts [cap, 3] f32 in bbox coords, tris
    [2·face_capacity, 3] int32 vertex indices (positions in the compacted
    actives), n_quads). One vertex per active cell, the mean of its
    cube-edge crossings, smooth in ``vals``; a quad per sign-changing
    min-corner lattice edge, wound outward (inside > level), its neighbours
    found by a binary search over the ascending ids. Connectivity is
    integer compaction and carries no gradient. The first 2·n_quads rows of
    ``tris`` are the valid ones."""
    nc = R - 1
    cap = cell_flat.shape[0]
    v = vals.float()
    pad = cell_flat < 0
    cf = cell_flat.clamp(min=0).long()
    cells = torch.stack([cf // (nc * nc), (cf // nc) % nc, cf % nc], dim=1)
    verts = _sn_vertices(cells, v, level, R, box_v)
    # padding takes the largest key so that the ids stay ascending
    sorted_ids = torch.where(pad, torch.iinfo(torch.int64).max, cf)

    def lookup(ids):
        pos = torch.searchsorted(sorted_ids, ids).clamp(max=cap - 1)
        return torch.where(sorted_ids[pos] == ids, pos, -1).to(torch.int32)

    quads, valid = _sn_quads(cells, cf, v, pad, lookup, nc, level)
    qbuf, nq = compact_rows(valid, quads, face_capacity, -1)
    tris = torch.stack([qbuf[:, (0, 1, 2)], qbuf[:, (0, 2, 3)]], dim=1)
    return verts, tris.reshape(2 * face_capacity, 3), nq


def assemble_sparse_grid(coarse16, blk_idx, fine16, octree_resolution: int, block: int,
                         coarse_factor: int) -> np.ndarray:
    """Host (numpy) assembly of :meth:`HierarchicalVolumeDecoding.decode_sparse`'s
    output into a dense [1, res, res, res] f16 grid: the refined blocks over
    the coarse grid's nearest-neighbour upsampling (every surface cell lies
    in a refined block, so the background only has to carry the sign)."""
    coarse, blk_idx, fine_vals = (x.cpu().numpy() for x in (coarse16, blk_idx, fine16))
    res = octree_resolution + 1
    s = block // coarse_factor
    nb = _cdiv(res, block)
    cn = np.minimum((np.arange(res) + s // 2) // s, coarse.shape[0] - 1)
    bg = coarse[np.ix_(cn, cn, cn)]
    loc = np.arange(block)
    lx, ly, lz = (a.reshape(-1)[None] for a in np.meshgrid(loc, loc, loc, indexing="ij"))
    gx = (blk_idx // (nb * nb))[:, None] * block + lx
    gy = ((blk_idx // nb) % nb)[:, None] * block + ly
    gz = (blk_idx % nb)[:, None] * block + lz
    ok = (gx < res) & (gy < res) & (gz < res)
    flat = (gx.astype(np.int64) * res + gy) * res + gz
    bg.reshape(-1)[flat[ok]] = fine_vals[ok]
    return bg[None]


def surface_nets_from_grid(grid: torch.Tensor, level: float, box_v: float, capacity: int,
                           face_capacity: int, block_edge: int = 8, block_capacity: int = None):
    """Active-cell compaction + surface-nets emission on the grid's device.

    grid [1, R, R, R] or [R, R, R] → (verts [capacity, 3] f32 in bbox coords,
    quads [face_capacity, 4] int32, nq, count, ok). ``ok`` is False when a
    buffer overflowed; the buffers then hold the stable truncation (the
    first cells and quads in order, quads on dropped cells masked out).
    """
    g = grid[0] if grid.dim() == 4 else grid
    dev = g.device
    R = g.shape[0]
    nc = R - 1
    E = block_edge
    nb = _cdiv(nc, E)
    P = nb * E

    active = _active_mask(g, level)
    count = active.sum()
    if P != nc:
        active = F.pad(active, (0, P - nc, 0, P - nc, 0, P - nc))
    ab = active.reshape(nb, E, nb, E, nb, E).permute(0, 2, 4, 1, 3, 5).reshape(nb ** 3, E ** 3)

    # stage A: compact the occupied spatial blocks
    if block_capacity is None:
        block_capacity = max(1024, 6 * nb * nb)
    bcap = min(nb ** 3, block_capacity)
    blk_any = ab.any(dim=1)
    bsel, nblk = compact_rows(blk_any, torch.arange(nb ** 3, dtype=torch.int32, device=dev),
                              bcap, -1)
    ok = nblk <= bcap

    # stage B: compact the active cells inside the selected blocks
    bsafe = bsel.clamp(min=0).long()
    act_sel = ab[bsafe] & (bsel >= 0)[:, None]
    bx, by, bz = bsafe // (nb * nb), (bsafe // nb) % nb, bsafe % nb
    li = torch.arange(E ** 3, device=dev)
    lx, ly, lz = li // (E * E), (li // E) % E, li % E
    gid = ((bx[:, None] * E + lx) * nc + (by[:, None] * E + ly)) * nc + (bz[:, None] * E + lz)
    cell_flat, _ = compact_rows(act_sel.reshape(-1), gid.reshape(-1).to(torch.int32),
                                capacity, -1)
    ok = ok & (count <= capacity)

    # corner values + one vertex per cell (mean of the edge crossings)
    pad = cell_flat < 0
    cf = cell_flat.clamp(min=0).long()
    cells = torch.stack([cf // (nc * nc), (cf // nc) % nc, cf % nc], dim=1)
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=dev)
    cc = cells[:, None, :] + corners[None]                     # [cap, 8, 3]
    pflat = (cc[..., 0] * R + cc[..., 1]) * R + cc[..., 2]
    v = g.reshape(-1)[pflat].float()                           # [cap, 8]
    verts = _sn_vertices(cells, v, level, R, box_v)

    # inverse map (cell id → compacted position) + faces
    inv = torch.full((nc ** 3 + 1,), -1, dtype=torch.int32, device=dev)
    inv[torch.where(pad, nc ** 3, cf)] = torch.arange(capacity, dtype=torch.int32, device=dev)
    quads, valid = _sn_quads(cells, cf, v, pad, lambda ids: inv[ids.clamp(min=0)], nc, level)
    qbuf, nq = compact_rows(valid, quads, face_capacity, -1)
    ok = ok & (nq <= face_capacity)
    return verts, qbuf, nq, count, ok


def quads_to_tris(quads) -> np.ndarray:
    """[n, 4] quads → [2n, 3] triangles (host side)."""
    q = np.asarray(quads)
    return np.stack([q[:, (0, 1, 2)], q[:, (0, 2, 3)]], axis=1).reshape(-1, 3)
