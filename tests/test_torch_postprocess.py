"""The port's mesh postprocess and mesh file formats against the JAX
package's, on the CPU.

The four native mesh functions are the same C++ built with the same flags,
so they must give the same arrays; the postprocess stages built on them, and
the OBJ / PLY / STL writers, must give equal meshes and equal bytes.
"""

import os

import numpy as np
import pytest

from hunyuan3d2_tpu import native as jnative
from hunyuan3d2_tpu.geometry import postprocess as jpost
from hunyuan3d2_tpu.geometry.mesh import Mesh as JMesh
from hunyuan3d2_tpu_torch import native as tnative
from hunyuan3d2_tpu_torch.geometry import postprocess as tpost
from hunyuan3d2_tpu_torch.geometry.mesh import Mesh


def _uv_sphere(n_lat: int, n_lon: int, radius: float = 0.8):
    """A UV sphere with a duplicated seam column and repeated pole vertices
    (exactly coincident vertices for the weld)."""
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon + 1)          # seam: first == last column
    t, p = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1) * radius
    v = v.reshape(-1, 3).astype(np.float32)
    idx = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    f = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)]).astype(np.int32)
    return v, f


def _fixture(n_lat: int = 24, n_lon: int = 48):
    """The sphere, two floaters (a small and a tiny tetrahedron), and
    degenerate faces: repeated indices, a zero-area sliver, a duplicate."""
    v, f = _uv_sphere(n_lat, n_lon)
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tf = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)
    parts_v, parts_f = [v], [f]
    for off, scale in ((1.5, 0.05), (-1.4, 0.01)):
        parts_f.append(tf + sum(len(x) for x in parts_v))
        parts_v.append(tet * scale + off)
    line = np.array([[0.0, -1.2, 0.0], [0.1, -1.2, 0.0], [0.2, -1.2, 0.0]], np.float32)
    parts_f.append(np.array([[0, 1, 2]], np.int32) + sum(len(x) for x in parts_v))
    parts_v.append(line)
    v = np.concatenate(parts_v)
    f = np.concatenate(parts_f + [np.array([[5, 5, 9], [10, 11, 10]], np.int32), f[:3]])
    return v.astype(np.float32), f.astype(np.int32)


@pytest.fixture(scope="module")
def mesh():
    return _fixture()


def test_native_face_components_matches(mesh):
    v, f = mesh
    labels, n = tnative.face_components(f, len(v))
    jl, jn = jnative.face_components(f, len(v))
    assert n == jn and n >= 4
    np.testing.assert_array_equal(labels, jl)


@pytest.mark.parametrize("name,args", [("simplify", (500,)), ("weld_dedup", ()),
                                       ("cluster_decimate", (0.05,))])
def test_native_mesh_functions_match(mesh, name, args):
    v, f = mesh
    ov, of = getattr(tnative, name)(v, f, *args)
    jv, jf = getattr(jnative, name)(v, f, *args)
    assert len(of) > 0 and len(of) < len(f)
    np.testing.assert_array_equal(ov, jv)
    np.testing.assert_array_equal(of, jf)


def test_native_mesh_functions_check_indices():
    v, f = _uv_sphere(4, 8)
    bad = f.copy()
    bad[0, 0] = len(v)
    for fn in (lambda: tnative.simplify(v, bad, 10), lambda: tnative.weld_dedup(v, bad),
               lambda: tnative.cluster_decimate(v, bad, 0.1),
               lambda: tnative.face_components(bad, len(v))):
        with pytest.raises(ValueError, match="out of range"):
            fn()


def _same(out, ref):
    np.testing.assert_array_equal(out.vertices, np.asarray(ref.vertices, np.float32))
    np.testing.assert_array_equal(out.faces, np.asarray(ref.faces, np.int32))


@pytest.mark.parametrize("stage", ["FloaterRemover", "DegenerateFaceRemover"])
def test_cleanup_stages_match(mesh, stage):
    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    v, f = mesh
    out = getattr(tpost, stage)()(Mesh(v, f))
    ref = getattr(jpost, stage)()(JMesh(v, f))
    assert len(out.faces) < len(f)
    _same(out, ref)
    assert stage in LAST_TIMINGS


@pytest.mark.parametrize("max_facenum", [1000, 4000], ids=["cluster_prepass", "quadric_only"])
def test_face_reducer_matches(max_facenum):
    """Above 8× the budget the cluster pre-pass runs first; below, quadric
    collapse alone."""
    v, f = _uv_sphere(64, 128)             # 16,384 faces
    assert (len(f) > 8 * max_facenum) == (max_facenum == 1000)
    mesh = Mesh(v, f, metadata={"k": 1})
    out = tpost.FaceReducer()(mesh, max_facenum=max_facenum)
    ref = jpost.FaceReducer()(JMesh(v, f, metadata={"k": 1}), max_facenum=max_facenum)
    assert 0 < len(out.faces) <= max_facenum and out.metadata == {"k": 1}
    _same(out, ref)
    assert tpost.FaceReducer()(mesh, max_facenum=len(f)) is mesh


def test_simplifier_normalize_and_chain_match(mesh):
    v, f = mesh
    _same(tpost.MeshSimplifier()(Mesh(v, f), ratio=0.2),
          jpost.MeshSimplifier()(JMesh(v, f), ratio=0.2))
    _same(tpost.mesh_normalize(Mesh(v * 3 + 1, f)), jpost.mesh_normalize(JMesh(v * 3 + 1, f)))
    # the apps' chain before texturing
    out = tpost.FaceReducer()(tpost.DegenerateFaceRemover()(tpost.FloaterRemover()(Mesh(v, f))),
                              max_facenum=800)
    ref = jpost.FaceReducer()(jpost.DegenerateFaceRemover()(jpost.FloaterRemover()(JMesh(v, f))),
                              max_facenum=800)
    _same(out, ref)


def _attributed(cls):
    v, f = _uv_sphere(6, 12)
    rs = np.random.RandomState(0)
    m = cls(v, f)
    m.uv = rs.rand(len(v), 2).astype(np.float32)
    m.compute_vertex_normals()
    m.vertex_colors = rs.randint(0, 255, (len(v), 3)).astype(np.uint8)
    m.texture = rs.randint(0, 255, (16, 16, 3)).astype(np.uint8)
    return m


def test_mesh_ops_match():
    out, ref = _attributed(Mesh), _attributed(JMesh)
    np.testing.assert_array_equal(out.normals, ref.normals)
    np.testing.assert_array_equal(out.face_normals(), ref.face_normals())
    np.testing.assert_array_equal(out.bounds, ref.bounds)
    c = out.copy()
    c.vertices[0] += 1
    assert not np.array_equal(c.vertices, out.vertices)
    np.testing.assert_array_equal(out.copy().flip_winding().faces, ref.copy().flip_winding().faces)
    out.faces, ref.faces = out.faces[10:], ref.faces[10:]
    out.remove_unreferenced_vertices()
    ref.remove_unreferenced_vertices()
    for name in ("vertices", "faces", "uv", "normals", "vertex_colors"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name))


@pytest.mark.parametrize("ext", ["obj", "ply", "stl"])
def test_export_writes_the_jax_bytes_and_reads_back(tmp_path, ext):
    out, ref = _attributed(Mesh), _attributed(JMesh)
    if ext == "obj":  # an OBJ carries uv and normals; a PLY the vertex colours
        out.vertex_colors = ref.vertex_colors = None
    paths = {}
    for tag, m in (("port", out), ("jax", ref)):
        os.makedirs(tmp_path / tag)
        paths[tag] = str(tmp_path / tag / f"m.{ext}")
        m.export(paths[tag])
    for name in sorted(os.listdir(tmp_path / "jax")):    # .obj writes .mtl and .png beside it
        with open(tmp_path / "port" / name, "rb") as a, open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    if ext == "stl":
        return
    back, jback = Mesh.load(paths["port"]), JMesh.load(paths["jax"])
    for name in ("vertices", "faces", "uv", "normals", "vertex_colors"):
        a, b = getattr(back, name), getattr(jback, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.faces, out.faces)
    np.testing.assert_allclose(back.vertices, out.vertices, atol=1e-6)


def test_load_splits_obj_corners_and_reads_ascii_ply(tmp_path):
    """An OBJ whose vertex takes two uvs becomes per-corner vertices; an
    ASCII PLY reads as the JAX loader reads it."""
    obj = tmp_path / "s.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\n"
                   "vt 0.5 0.5\nf 1/1 2/2 3/3\nf 2/5 4/4 3/3\n")
    ply = tmp_path / "a.ply"
    ply.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\nproperty float y\n"
                   "property float z\nelement face 1\nproperty list uchar int vertex_indices\n"
                   "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    for p in (obj, ply):
        a, b = Mesh.load(str(p)), JMesh.load(str(p))
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
        if a.uv is not None:
            np.testing.assert_array_equal(a.uv, b.uv)
    assert len(Mesh.load(str(obj)).vertices) == 6
    with pytest.raises(ValueError, match="unsupported"):
        Mesh(np.zeros((3, 3)), np.array([[0, 1, 2]])).export(str(tmp_path / "x.fbx"))
