"""Checkpoint save and load of nested trees of tensors (the port's
counterpart of hunyuan3d2_tpu/io/orbax_io.py, on ``safetensors``).

A tree is nested dicts, lists and tuples whose leaves are tensors or plain
values: a module's ``state_dict()`` beside an optimizer's, for a training
run to checkpoint and resume (training/flow_match.py). The tensors go into
one ``.safetensors`` file under their '/'-joined paths; the tree's shape and
its other leaves (an optimizer's param-group hyper-parameters and ``step``
counts, None, numbers, strings) go into the file's metadata as JSON, with
dict keys that keep their type (an optimizer state's keys are ints).
"""

from __future__ import annotations

import json
import os

import safetensors
import safetensors.torch
import torch


def _encode(node, path, tensors):
    if isinstance(node, torch.Tensor):
        name = "/".join(path) or "."
        tensors[name] = node.detach().to("cpu", copy=True).contiguous()
        return {"tensor": name}
    if isinstance(node, dict):
        items = []
        for k, v in node.items():
            if not isinstance(k, (str, int)) or isinstance(k, bool):
                raise TypeError(f"save_pytree: key {k!r} at {'/'.join(path)} is not a str or int")
            items.append([k, _encode(v, path + [str(k)], tensors)])
        return {"dict": items}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, path + [str(i)], tensors) for i, v in enumerate(node)]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"save_pytree: leaf of type {type(node).__name__} at {'/'.join(path)}")


def save_pytree(path: str, tree) -> str:
    """Write ``tree`` to ``path`` (one safetensors file); returns the
    absolute path."""
    path = os.path.abspath(path)
    tensors = {}
    skeleton = _encode(tree, [], tensors)
    safetensors.torch.save_file(tensors, path, metadata={"tree": json.dumps(skeleton)})
    return path


def _decode(node, tensors, target):
    if "tensor" in node:
        t = tensors[node["tensor"]]
        if isinstance(target, torch.Tensor):
            if tuple(target.shape) != tuple(t.shape):
                raise ValueError(f"load_pytree: {node['tensor']} is {tuple(t.shape)} in the "
                                 f"file, {tuple(target.shape)} in the target")
            t = t.to(device=target.device, dtype=target.dtype)
        return t
    if "dict" in node:
        sub = target if isinstance(target, dict) else {}
        return {k: _decode(v, tensors, sub.get(k)) for k, v in node["dict"]}
    for kind, cls in (("list", list), ("tuple", tuple)):
        if kind in node:
            sub = target if isinstance(target, (list, tuple)) else ()
            return cls(_decode(v, tensors, sub[i] if i < len(sub) else None)
                       for i, v in enumerate(node[kind]))
    return node["value"]


def load_pytree(path: str, target=None):
    """The tree saved at ``path``. With ``target`` (a tree of the same
    shape, e.g. a fresh module's ``state_dict()``), each tensor that has a
    counterpart there takes that tensor's dtype and device (a shape that
    differs raises); the others stay as saved, on the CPU. The tree's shape
    is the file's: an optimizer's state is restored where the target's
    fresh optimizer has none yet."""
    path = os.path.abspath(path)
    with safetensors.safe_open(path, framework="pt") as fh:
        skeleton = json.loads(fh.metadata()["tree"])
        tensors = {k: fh.get_tensor(k) for k in fh.keys()}
    return _decode(skeleton, tensors, target)
