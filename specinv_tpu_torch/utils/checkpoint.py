"""Checkpoint / resume of algorithm states.

Counterpart of ``specinv_tpu/utils/checkpoint.py``, in its ``.npz`` format:
the state's leaves as ``leaf_0``, ``leaf_1``, ... in flatten order, the
structure supplied at load time by a template (``load_state``'s ``like``).
Leaves are flattened with ``torch.utils._pytree`` in the JAX package's order
(JAX sorts dict keys, torch's pytree keeps insertion order), so a state saved
by either package loads in the other::

    save_state("ckpt.npz", state)           # e.g. models.admm.ADMMState
    state = load_state("ckpt.npz", like=state)
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _canonical(tree):
    """``tree`` with every dict's keys in sorted order (JAX's leaf order)."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(_canonical, tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(_canonical, tree))
    return tree


def _restore(like, tree):
    """``tree`` (canonical order) with ``like``'s dict key order."""
    if isinstance(like, dict):
        return {k: _restore(like[k], tree[k]) for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_restore(a, b) for a, b in zip(like, tree)))
    if isinstance(like, (tuple, list)):
        return type(like)(_restore(a, b) for a, b in zip(like, tree))
    return tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state) -> None:
    """Serialize a pytree of tensors (or arrays) to ``path`` (.npz)."""
    leaves, _ = pytree.tree_flatten(_canonical(state))
    np.savez(path, **{f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)})


def load_state(path: str, like):
    """Restore a pytree saved by :func:`save_state` (or by the JAX
    package's).  ``like`` supplies the structure; each stored array becomes
    a tensor on the device of ``like``'s leaf in its place (the CPU where
    that leaf is no tensor)."""
    with np.load(path) as data:
        stored = [data[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in data.files))]
    like_leaves, spec = pytree.tree_flatten(_canonical(like))
    if len(like_leaves) != len(stored):
        raise ValueError(
            f"checkpoint has {len(stored)} leaves, state template has {len(like_leaves)}"
        )
    leaves = [
        torch.from_numpy(np.array(arr)).to(
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        for arr, ref in zip(stored, like_leaves)
    ]
    return _restore(like, pytree.tree_unflatten(leaves, spec))
