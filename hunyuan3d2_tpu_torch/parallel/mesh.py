"""Process groups and the (dp, tp) device mesh (port of
hunyuan3d2_tpu/parallel/mesh.py).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
an initialised process group, one rank per device: a data axis ("dp": CFG
pairs, batches) and a model axis ("tp": attention heads and MLP widths of
the transformers). The default backend is NCCL on ``cuda``; the CPU tests
ask for gloo on ``cpu`` explicitly. Nothing falls back from one to the
other: a mesh asked for on ``cuda`` where no card is raises.

:func:`spawn` runs a function on ``world_size`` fresh processes joined by a
``file://`` store in a temporary directory (no TCP port, so parallel test
workers never collide) and returns each rank's result.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def init_process_group(backend: str = "nccl", device: str = "cuda",
                       init_method: Optional[str] = None, world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> None:
    """Initialise the default process group. ``world_size`` and ``rank``
    default to $WORLD_SIZE and $RANK (torchrun's), else 1 and 0;
    ``init_method`` to ``env://`` where $MASTER_ADDR is set, else (one
    rank only) a ``file://`` store in a temporary directory. On ``cuda``
    the process takes the card of its local rank ($LOCAL_RANK, else the rank
    modulo the card count)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"init_process_group: {backend} on cuda, but no CUDA device is "
                           "available; pass backend='gloo', device='cpu' for a CPU run")
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = "file://" + os.path.join(tempfile.mkdtemp(), "store")
        else:
            raise ValueError("init_process_group: pass init_method (or run under torchrun) "
                             f"for {world_size} ranks")
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def _spawned(rank: int, fn: Callable, world_size: int, backend: str, device: str, store: str):
    args = torch.load(os.path.join(store, "args.pt"), weights_only=False)
    init_process_group(backend, device, "file://" + os.path.join(store, "store"), world_size,
                       rank)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(store, f"result.{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str = "nccl", device: str = "cuda",
          args: tuple = ()) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` spawned processes, each in
    the process group (``backend`` on ``device``); return the ranks' results
    in rank order. ``fn`` is pickled, so it is a module level function;
    ``args`` go through a file (a large argument written down each child's
    start-up pipe would start the children one after another). A rank that
    raises makes this raise."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as store:
        torch.save(args, os.path.join(store, "args.pt"))
        mp.spawn(_spawned, args=(fn, world_size, backend, device, store),
                 nprocs=world_size, join=True)
        return [torch.load(os.path.join(store, f"result.{r}.pt"), weights_only=False)
                for r in range(world_size)]


def mesh_shape(n: int, dp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) for ``n`` ranks: dp = 2 when n is even and ≥ 4 (one CFG pair
    per dp group), else 1, unless given."""
    if dp is None:
        dp = 2 if n % 2 == 0 and n >= 4 else 1
    if n % dp:
        raise ValueError(f"make_mesh: dp={dp} does not divide {n} ranks")
    return dp, n // dp


def group_size(device: str) -> int:
    """The initialised process group's size; raises without one, or for a
    ``cuda`` mesh where no card is."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mesh: a cuda mesh needs a CUDA device; pass device='cpu' "
                           "with a gloo process group for a CPU run")
    if not dist.is_initialized():
        raise RuntimeError("mesh: no process group; call parallel.mesh.init_process_group "
                           "(or run under torchrun) first")
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("dp", "tp"),
              dp: Optional[int] = None, device: str = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh over the first ``n_devices`` ranks (all by default)
    of the initialised process group, dp by :func:`mesh_shape`. The axes
    are named ("dp", "tp"): the sharding rules look them up by name."""
    if tuple(axis_names) != ("dp", "tp"):
        raise ValueError(f"make_mesh: axis_names {tuple(axis_names)}; the port shards over "
                         "('dp', 'tp')")
    avail = group_size(device)
    if n_devices is not None and avail < n_devices:
        raise RuntimeError(f"make_mesh: {n_devices} ranks requested but only {avail} in the "
                           "process group; start more ranks (parallel.mesh.spawn, torchrun)")
    n = n_devices or avail
    dp, tp = mesh_shape(n, dp)
    return DeviceMesh(device, torch.arange(n).reshape(dp, tp), mesh_dim_names=tuple(axis_names))


# the meshes of make_mesh and parallel/pipeline.py make_pp_mesh
LAYOUTS = (("dp", "tp"), ("dp", "pp"))


def axis(mesh: Optional[DeviceMesh], name: str):
    """(group, size, this rank's index) of the mesh axis ``name``; None when
    there is no mesh, no such axis, or the axis has one rank. A mesh whose
    axes are not one of :data:`LAYOUTS` raises, rather than leave the model
    whole on every rank."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names or ())
    if names not in LAYOUTS:
        raise ValueError(f"mesh axes {names}: the port shards over a {LAYOUTS[0]} mesh "
                         f"(make_mesh) or a {LAYOUTS[1]} one (make_pp_mesh)")
    if name not in names:
        return None
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return None
    return mesh.get_group(name), size, mesh.get_local_rank(name)
