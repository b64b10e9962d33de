"""Triangle-mesh container with a binary glTF (GLB) writer and reader.

Copied from hunyuan3d2_tpu/geometry/mesh.py (the parts the image → mesh
path uses) so the port imports nothing of the JAX package: vertices [N, 3]
float32, faces [M, 3] int32 (CCW winding), and a single-buffer glTF 2.0
export.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    vertices: np.ndarray                  # [N, 3] float32
    faces: np.ndarray                     # [M, 3] int32

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.faces = np.ascontiguousarray(self.faces, dtype=np.int32)

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

        def add_blob(data: bytes, target: int) -> int:
            nonlocal offset
            pad = (-len(data)) % 4
            blobs.append(data + b"\x00" * pad)
            views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(data),
                          "target": target})
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
        gltf = {
            "asset": {"version": "2.0", "generator": "hunyuan3d2_tpu_torch"},
            "scene": 0,
            "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 1}, "indices": 0,
                                        "mode": 4}]}],
            "accessors": accessors,
            "bufferViews": views,
        }
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
        """Read back a GLB written by :meth:`export` (positions and indices)."""
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
            n_comp = {"SCALAR": 1, "VEC3": 3}[a["type"]]
            arr = np.frombuffer(bin_blob, comp, count=a["count"] * n_comp,
                                offset=bv.get("byteOffset", 0))
            return arr.reshape(a["count"], n_comp) if n_comp > 1 else arr

        prim = g["meshes"][0]["primitives"][0]
        return cls(read_accessor(prim["attributes"]["POSITION"]),
                   read_accessor(prim["indices"]).astype(np.int32).reshape(-1, 3))
