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


def gated_unwrap(directory, vertices, faces):
    """The unwrap, held open around the parent's denoise: it writes
    ``<directory>/started`` and waits (at most a minute) for
    ``<directory>/denoised`` before it unwraps."""
    import time

    from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap_arrays

    open(os.path.join(directory, "started"), "w").close()
    deadline = time.monotonic() + 60
    while not os.path.exists(os.path.join(directory, "denoised")):
        if time.monotonic() > deadline:
            raise TimeoutError("the parent never finished its denoise")
        time.sleep(0.005)
    return mesh_uv_wrap_arrays(vertices, faces)
