"""Functions that tests/test_torch_texgen_overlap.py runs in the port's host
worker process. Module-level, so they pickle; they import no JAX (the
worker must not load it)."""

import os
import sys


def unwrap_out_of_range(vertices, faces):
    """The worker's unwrap entry on the mesh with one face index out of
    range: ``mesh_uv_wrap`` raises IndexError inside the worker."""
    from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap_arrays

    faces = faces.copy()
    faces[0, 0] = len(vertices) + 5
    return mesh_uv_wrap_arrays(vertices, faces)


def unwrap_dies(vertices, faces):
    """A worker that dies in the middle of the unwrap."""
    os._exit(3)


def worker_state():
    """The worker's thread caps and which of torch, jax and the JAX package
    it has loaded."""
    loaded = [m for m in ("torch", "jax", "hunyuan3d2_tpu") if m in sys.modules]
    return {var: os.environ.get(var) for var in
            ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}, loaded
