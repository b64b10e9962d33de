"""Tensor, data and pipeline parallelism on torch.distributed (port of
hunyuan3d2_tpu/parallel)."""

from hunyuan3d2_tpu_torch.parallel.mesh import make_mesh
from hunyuan3d2_tpu_torch.parallel.pipeline import make_pp_mesh, pp_apply
from hunyuan3d2_tpu_torch.parallel.sharding import (
    dit_param_spec,
    shard_params,
    shard_batch,
)

__all__ = ["make_mesh", "make_pp_mesh", "pp_apply", "dit_param_spec",
           "shard_params", "shard_batch"]
