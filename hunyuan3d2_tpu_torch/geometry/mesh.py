"""Triangle-mesh container with a binary glTF (GLB) writer and reader.

Copied from hunyuan3d2_tpu/geometry/mesh.py (the parts the port's paths
use) so the port imports nothing of the JAX package: vertices [N, 3]
float32, faces [M, 3] int32 (CCW winding), optional per-vertex uv [N, 2]
(OBJ convention, origin bottom-left) and a texture image [H, W, 3|4] uint8
bound through uv. The GLB carries POSITION, TEXCOORD_0 (flipped to glTF's
top-left origin) and the texture as an embedded PNG base-colour map.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from dataclasses import dataclass
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


@dataclass
class Mesh:
    vertices: np.ndarray                  # [N, 3] float32
    faces: np.ndarray                     # [M, 3] int32
    uv: Optional[np.ndarray] = None       # [N, 2] float32 in [0, 1]
    texture: Optional[np.ndarray] = None  # [H, W, 3|4] uint8

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.faces = np.ascontiguousarray(self.faces, dtype=np.int32)
        if self.uv is not None:
            self.uv = np.ascontiguousarray(self.uv, dtype=np.float32)

    def export(self, path: str):
        if not str(path).lower().endswith(".glb"):
            raise ValueError(f"unsupported mesh format (the port writes .glb): {path}")
        with open(path, "wb") as fh:
            fh.write(self.to_glb_bytes())
        return path

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
        """Read back a GLB written by :meth:`export` (positions, indices, uv
        and the embedded texture)."""
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
