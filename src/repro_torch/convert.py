"""Carry weights between the JAX package's parameter tree and the port.

The JAX ``LM.init`` tree (nested dicts and lists of arrays, converted to
numpy by the caller) and :class:`repro_torch.models.LM` share key paths:
``tree["blocks"][0]["mixer"]["wq"]`` is the parameter
``blocks.0.mixer.wq``.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_params", "to_numpy_tree", "flatten_tree"]


def flatten_tree(tree, prefix: str = "") -> dict:
    """``{"blocks.0.mixer.wq": leaf, ...}`` for a nested dict/list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, val in items:
        name = f"{prefix}{key}"
        if isinstance(val, (dict, list, tuple)):
            out.update(flatten_tree(val, name + "."))
        else:
            out[name] = val
    return out


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":      # ml_dtypes bf16: carry the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Fill ``model``'s parameters from a JAX-layout tree of arrays.

    The key sets and every shape must match exactly; values are cast to
    the parameter's dtype and copied onto its device.
    """
    leaves = flatten_tree(tree)
    params = dict(model.named_parameters())
    if leaves.keys() != params.keys():
        raise KeyError(
            f"parameter trees differ: only in JAX {sorted(leaves.keys() - params.keys())}, "
            f"only in the port {sorted(params.keys() - leaves.keys())}")
    for name, arr in leaves.items():
        src = _to_tensor(arr)
        dst = params[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: JAX shape {tuple(src.shape)} vs port "
                             f"{tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))
    return model


def to_numpy_tree(model: torch.nn.Module) -> dict:
    """The model's parameters as a JAX-layout tree of numpy arrays.

    bf16 parameters come back widened to f32 (exact), since numpy has
    no bf16 of its own.
    """
    tree: dict = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        node, parts = tree, name.split(".")
        for i, part in enumerate(parts[:-1]):
            nxt = {} if not parts[i + 1].isdigit() else []
            if isinstance(node, list):
                idx = int(part)
                while len(node) <= idx:
                    node.append(None)
                if node[idx] is None:
                    node[idx] = nxt
                node = node[idx]
            else:
                node = node.setdefault(part, nxt)
        node[parts[-1]] = arr
    return tree
