"""Triangle-mesh container with OBJ / PLY / STL / GLB writers and OBJ / PLY /
GLB readers.

Copied from hunyuan3d2_tpu/geometry/mesh.py so the port imports nothing of
the JAX package: vertices [N, 3] float32, faces [M, 3] int32 (CCW winding),
optional per-vertex uv [N, 2] (OBJ convention, origin bottom-left), normals
[N, 3], vertex colours [N, 3|4] and a texture image [H, W, 3|4] uint8 bound
through uv. The GLB carries POSITION, TEXCOORD_0 (flipped to glTF's
top-left origin) and the texture as an embedded PNG base-colour map; OBJ
writes the texture beside it as .png + .mtl; PLY is binary little-endian
with optional vertex colours; STL is binary, geometry only.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _png_bytes(img: np.ndarray) -> bytes:
    """PNG-encode; an atlas that barely compresses at zlib level 1 is written
    at level 1 (level 6 costs several times the time for the same size)."""
    from PIL import Image

    level = 6
    if img.ndim == 3 and img.shape[0] >= 256:
        sample = np.ascontiguousarray(img[:: img.shape[0] // 64][:64])
        if len(zlib.compress(sample.tobytes(), 1)) > 0.8 * sample.nbytes:
            level = 1
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", compress_level=level)
    return buf.getvalue()


def _write_png(path: str, img: np.ndarray):
    with open(path, "wb") as fh:
        fh.write(_png_bytes(img))


@dataclass
class Mesh:
    vertices: np.ndarray                        # [N, 3] float32
    faces: np.ndarray                           # [M, 3] int32
    uv: Optional[np.ndarray] = None             # [N, 2] float32 in [0, 1]
    normals: Optional[np.ndarray] = None        # [N, 3] float32
    vertex_colors: Optional[np.ndarray] = None  # [N, 3|4] float32 or uint8
    texture: Optional[np.ndarray] = None        # [H, W, 3|4] uint8
    metadata: dict = field(default_factory=dict)

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.faces = np.ascontiguousarray(self.faces, dtype=np.int32)
        if self.uv is not None:
            self.uv = np.ascontiguousarray(self.uv, dtype=np.float32)

    def copy(self) -> "Mesh":
        def dup(x):
            return None if x is None else x.copy()

        return Mesh(self.vertices.copy(), self.faces.copy(), dup(self.uv), dup(self.normals),
                    dup(self.vertex_colors), dup(self.texture), dict(self.metadata))

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    def face_normals(self) -> np.ndarray:
        v, f = self.vertices, self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

    def compute_vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals, kept on the mesh and returned."""
        v, f = self.vertices, self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for i in range(3):
            np.add.at(vn, f[:, i], fn)
        self.normals = vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
        return self.normals

    def flip_winding(self) -> "Mesh":
        """Reverse every triangle's orientation in place."""
        self.faces = self.faces[:, ::-1].copy()
        return self

    def remove_unreferenced_vertices(self) -> "Mesh":
        """Drop vertices no face uses (and their per-vertex attributes), in
        place, keeping the order of the rest."""
        used = np.zeros(len(self.vertices), dtype=bool)
        used[self.faces.reshape(-1)] = True
        remap = np.cumsum(used) - 1
        self.vertices = self.vertices[used]
        if self.uv is not None:
            self.uv = self.uv[used]
        if self.normals is not None:
            self.normals = self.normals[used]
        if self.vertex_colors is not None:
            self.vertex_colors = self.vertex_colors[used]
        self.faces = remap[self.faces].astype(np.int32)
        return self

    def export(self, path: str):
        """Write by extension: .obj, .ply, .stl or .glb."""
        writers = {".obj": self._export_obj, ".ply": self._export_ply,
                   ".stl": self._export_stl, ".glb": self._export_glb}
        ext = os.path.splitext(str(path))[1].lower()
        if ext not in writers:
            raise ValueError(f"unsupported mesh format: {path}")
        writers[ext](path)
        return path

    def _export_glb(self, path: str):
        with open(path, "wb") as fh:
            fh.write(self.to_glb_bytes())

    def _export_stl(self, path: str):
        """Binary STL: an 80-byte header, the count, 50 bytes a triangle."""
        f = self.faces.astype(np.int64)
        tri = self.vertices[f]                                  # [F, 3, 3]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        payload = np.empty((len(f),), dtype=[("n", "<3f4"), ("v", "<9f4"), ("attr", "<u2")])
        payload["n"] = n.astype("<f4")
        payload["v"] = tri.reshape(len(f), 9).astype("<f4")
        payload["attr"] = 0
        with open(path, "wb") as fh:
            fh.write(b"hy3d binary stl".ljust(80, b"\0"))
            fh.write(struct.pack("<I", len(f)))
            fh.write(payload.tobytes())

    def _export_obj(self, path: str):
        lines = []
        if self.texture is not None and self.uv is not None:
            base = path[: path.rfind(".")]
            _write_png(base + ".png", self.texture)
            mtl = base + ".mtl"
            with open(mtl, "w") as fh:
                fh.write("newmtl material_0\nKd 1 1 1\nmap_Kd %s\n" % (os.path.basename(base)
                                                                      + ".png"))
            lines += ["mtllib %s" % os.path.basename(mtl), "usemtl material_0"]
        lines += ["v %.6f %.6f %.6f" % tuple(v) for v in self.vertices]
        if self.uv is not None:
            lines += ["vt %.6f %.6f" % tuple(t) for t in self.uv]
        if self.normals is not None:
            lines += ["vn %.6f %.6f %.6f" % tuple(n) for n in self.normals]
        f1 = self.faces + 1
        if self.uv is not None and self.normals is not None:
            fmt = "f %d/%d/%d %d/%d/%d %d/%d/%d"
            lines += [fmt % (a, a, a, b, b, b, c, c, c) for a, b, c in f1]
        elif self.uv is not None:
            lines += ["f %d/%d %d/%d %d/%d" % (a, a, b, b, c, c) for a, b, c in f1]
        else:
            lines += ["f %d %d %d" % (a, b, c) for a, b, c in f1]
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")

    def _export_ply(self, path: str):
        n, m = len(self.vertices), len(self.faces)
        has_color = self.vertex_colors is not None
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if has_color:
            header += ["property uchar red", "property uchar green", "property uchar blue"]
        header += [f"element face {m}", "property list uchar int vertex_indices", "end_header"]
        with open(path, "wb") as fh:
            fh.write(("\n".join(header) + "\n").encode())
            if has_color:
                col = self.vertex_colors
                if col.dtype != np.uint8:
                    col = (np.clip(col, 0, 1) * 255).astype(np.uint8)
                rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                rec["xyz"] = self.vertices
                rec["rgb"] = col[:, :3]
                fh.write(rec.tobytes())
            else:
                fh.write(self.vertices.astype("<f4").tobytes())
            frec = np.zeros(m, dtype=[("cnt", np.uint8), ("idx", "<i4", 3)])
            frec["cnt"] = 3
            frec["idx"] = self.faces
            fh.write(frec.tobytes())

    def to_glb_bytes(self) -> bytes:
        """Serialize as a single-buffer binary glTF 2.0 asset."""
        v = self.vertices.astype("<f4")
        idx = self.faces.astype("<u4").reshape(-1)
        blobs, views, accessors = [], [], []
        offset = 0

        def add_blob(data: bytes, target: Optional[int]) -> int:
            nonlocal offset
            pad = (-len(data)) % 4
            blobs.append(data + b"\x00" * pad)
            views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(data),
                          **({"target": target} if target else {})})
            offset += len(data) + pad
            return len(views) - 1

        bv = add_blob(idx.tobytes(), 34963)
        accessors.append({"bufferView": bv, "componentType": 5125, "count": int(idx.size),
                          "type": "SCALAR", "max": [int(idx.max()) if idx.size else 0],
                          "min": [int(idx.min()) if idx.size else 0]})
        bv = add_blob(v.tobytes(), 34962)
        accessors.append({"bufferView": bv, "componentType": 5126, "count": int(len(v)),
                          "type": "VEC3", "max": v.max(0).tolist() if len(v) else [0, 0, 0],
                          "min": v.min(0).tolist() if len(v) else [0, 0, 0]})
        attributes = {"POSITION": 1}
        if self.uv is not None:
            uv = self.uv.astype("<f4").copy()
            uv[:, 1] = 1.0 - uv[:, 1]    # glTF's uv origin is top-left
            bv = add_blob(uv.tobytes(), 34962)
            accessors.append({"bufferView": bv, "componentType": 5126, "count": int(len(uv)),
                              "type": "VEC2"})
            attributes["TEXCOORD_0"] = len(accessors) - 1
        gltf = {
            "asset": {"version": "2.0", "generator": "hunyuan3d2_tpu_torch"},
            "scene": 0,
            "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": [{"attributes": attributes, "indices": 0, "mode": 4}]}],
            "accessors": accessors,
        }
        if self.texture is not None and self.uv is not None:
            bv = add_blob(_png_bytes(self.texture), None)
            gltf["images"] = [{"bufferView": bv, "mimeType": "image/png"}]
            gltf["samplers"] = [{"magFilter": 9729, "minFilter": 9987,
                                 "wrapS": 10497, "wrapT": 10497}]
            gltf["textures"] = [{"sampler": 0, "source": 0}]
            gltf["materials"] = [{"pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
                "roughnessFactor": 1.0}}]
            gltf["meshes"][0]["primitives"][0]["material"] = 0
        gltf["bufferViews"] = views
        bin_chunk = b"".join(blobs)
        gltf["buffers"] = [{"byteLength": len(bin_chunk)}]
        js = json.dumps(gltf, separators=(",", ":")).encode()
        js += b" " * ((-len(js)) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_chunk)
        out = b"glTF" + struct.pack("<II", 2, total)
        out += struct.pack("<I", len(js)) + b"JSON" + js
        out += struct.pack("<I", len(bin_chunk)) + b"BIN\x00" + bin_chunk
        return out

    @classmethod
    def load(cls, path: str) -> "Mesh":
        """Read an .obj, a .ply (binary or ASCII) or a GLB written by
        :meth:`export` (positions, indices, uv and the embedded texture)."""
        ext = os.path.splitext(str(path))[1].lower()
        if ext == ".obj":
            return _load_obj(path)
        if ext == ".ply":
            return _load_ply(path)
        if ext != ".glb":
            raise ValueError(f"unsupported mesh format: {path}")
        with open(path, "rb") as fh:
            magic, _version, _total = struct.unpack("<4sII", fh.read(12))
            if magic != b"glTF":
                raise ValueError(f"not a GLB file: {path}")
            json_blob = bin_blob = None
            while True:
                hdr = fh.read(8)
                if len(hdr) < 8:
                    break
                ln, typ = struct.unpack("<I4s", hdr)
                chunk = fh.read(ln)
                if typ == b"JSON":
                    json_blob = chunk
                elif typ == b"BIN\x00":
                    bin_blob = chunk
        g = json.loads(json_blob)

        def read_accessor(i):
            a = g["accessors"][i]
            bv = g["bufferViews"][a["bufferView"]]
            comp = {5125: "<u4", 5126: "<f4"}[a["componentType"]]
            n_comp = {"SCALAR": 1, "VEC2": 2, "VEC3": 3}[a["type"]]
            arr = np.frombuffer(bin_blob, comp, count=a["count"] * n_comp,
                                offset=bv.get("byteOffset", 0) + a.get("byteOffset", 0))
            return arr.reshape(a["count"], n_comp) if n_comp > 1 else arr

        prim = g["meshes"][0]["primitives"][0]
        mesh = cls(read_accessor(prim["attributes"]["POSITION"]),
                   read_accessor(prim["indices"]).astype(np.int32).reshape(-1, 3))
        if "TEXCOORD_0" in prim["attributes"]:
            uv = read_accessor(prim["attributes"]["TEXCOORD_0"]).astype(np.float32).copy()
            uv[:, 1] = 1.0 - uv[:, 1]
            mesh.uv = uv
        if g.get("images"):
            from PIL import Image

            bv = g["bufferViews"][g["images"][0]["bufferView"]]
            off = bv.get("byteOffset", 0)
            png = bin_blob[off: off + bv["byteLength"]]
            mesh.texture = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
        return mesh


def _load_obj(path: str) -> Mesh:
    """Positions, faces (polygons fanned into triangles), and uv and normals
    where every vertex has one; a vertex with two uvs splits the mesh into
    per-corner vertices."""
    vs, vts, vns, faces, face_uv_idx = [], [], [], [], []
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                vts.append([float(x) for x in t[1:3]])
            elif t[0] == "vn":
                vns.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                idx = [p.split("/") for p in t[1:]]
                for i in range(1, len(idx) - 1):
                    tri = [idx[0], idx[i], idx[i + 1]]
                    faces.append([int(p[0]) - 1 for p in tri])
                    if len(tri[0]) > 1 and tri[0][1]:
                        face_uv_idx.append([int(p[1]) - 1 for p in tri])
    v = np.array(vs, np.float32)
    f = np.array(faces, np.int32)
    uv = None
    if face_uv_idx and vts:
        vt = np.array(vts, np.float32)
        flat_v = f.reshape(-1)
        flat_t = np.array(face_uv_idx, np.int32).reshape(-1)
        seen = np.full(len(v), -1, np.int64)
        first = seen[flat_v] == -1
        seen[flat_v[first]] = flat_t[first]
        if (seen[flat_v] != flat_t).any():
            return Mesh(v[flat_v], np.arange(len(flat_v), dtype=np.int32).reshape(-1, 3),
                        uv=vt[flat_t])
        uv = np.zeros((len(v), 2), np.float32)
        uv[flat_v] = vt[flat_t]
    m = Mesh(v, f, uv=uv)
    if vns and len(vns) == len(vs):
        m.normals = np.array(vns, np.float32)
    return m


def _load_ply(path: str) -> Mesh:
    """Triangle PLY, binary little-endian (with optional rgb vertex colours)
    or ASCII."""
    with open(path, "rb") as fh:
        data = fh.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    fmt = "binary_little_endian"
    n_vert = n_face = 0
    vert_props = []
    cur = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = t[1]
            if t[1] == "vertex":
                n_vert = int(t[2])
            elif t[1] == "face":
                n_face = int(t[2])
        elif t[0] == "property" and cur == "vertex" and t[1] != "list":
            vert_props.append((t[2], t[1]))
    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1",
                "uint8": "u1", "int": "<i4", "uint": "<u4", "short": "<i2", "ushort": "<u2",
                "char": "i1"}
    if fmt.startswith("binary"):
        dt = np.dtype([(n, type_map[t]) for n, t in vert_props])
        body = data[header_end:]
        verts = np.frombuffer(body, dt, count=n_vert)
        v = np.stack([verts["x"], verts["y"], verts["z"]], 1).astype(np.float32)
        colors = None
        if "red" in verts.dtype.names:
            colors = np.stack([verts["red"], verts["green"], verts["blue"]], 1)
        fdt = np.dtype([("cnt", "u1"), ("idx", "<i4", 3)])
        faces = np.frombuffer(body, fdt, count=n_face, offset=n_vert * dt.itemsize)["idx"]
        return Mesh(v, faces.astype(np.int32), vertex_colors=colors)
    lines = data[header_end:].decode().splitlines()
    v = np.array([[float(x) for x in ln.split()[:3]] for ln in lines[:n_vert]], np.float32)
    faces = np.array([[int(x) for x in ln.split()[1:4]]
                      for ln in lines[n_vert:n_vert + n_face]], np.int32)
    return Mesh(v, faces)
