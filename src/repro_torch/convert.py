"""Carry weights between the JAX package's parameter tree and the port,
and walk such trees.

The JAX ``LM.init`` tree (nested dicts and lists of arrays, converted to
numpy by the caller) and :class:`repro_torch.models.LM` share key paths:
``tree["blocks"][0]["mixer"]["wq"]`` is the parameter
``blocks.0.mixer.wq``.  The optimizer state and the checkpoints use the
same trees, walked in JAX's leaf order (:func:`tree_paths`).  Nothing
here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_params", "to_numpy_tree", "flatten_tree", "param_tree",
           "tree_leaves", "tree_map", "tree_paths"]


def tree_paths(tree, prefix: str = "", sep: str = "/"):
    """``(path, leaf)`` pairs of a nested dict/list tree in JAX's leaf
    order: dict keys sorted, lists by index; ``/blocks/0/mixer/wq`` with
    the default ``sep``, as the checkpoint's key paths are spelled."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pair for key, val in items
            for pair in tree_paths(val, f"{prefix}{sep}{key}", sep)]


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree in JAX's leaf order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def flatten_tree(tree) -> dict:
    """``{"blocks.0.mixer.wq": leaf, ...}`` for a nested dict/list tree."""
    return {path[1:]: leaf for path, leaf in tree_paths(tree, sep=".")}


def _unflatten(named) -> dict:
    """The nested dict/list tree of ``(dotted name, leaf)`` pairs; a
    numeric name part opens a list."""
    tree: dict = {}
    for name, leaf in named:
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
        node[parts[-1]] = leaf
    return tree


def param_tree(model: torch.nn.Module) -> dict:
    """The model's parameters themselves as a JAX-layout tree: the tree
    that the trainer updates, the optimizer mirrors and the checkpoint
    saves under ``/params``."""
    return _unflatten(model.named_parameters())


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
    def arr(p):
        t = p.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(arr, param_tree(model))
