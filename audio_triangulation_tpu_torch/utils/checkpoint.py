"""Checkpoint / resume: the JAX package's ``.npz`` form, without JAX.

Counterpart of the JAX package's ``utils/checkpoint``.  A state is a tree of
dataclasses, named tuples, dicts, lists and tuples with tensors (or numpy
arrays, or numbers) as leaves; ``None`` is no leaf.  :func:`save` writes
every leaf under its key path, and :func:`restore` matches leaves by path.
The paths are the strings the JAX package writes (``"/".join(str(k) ...)``
of ``jax.tree_util.tree_flatten_with_path``): ``.field`` for a dataclass or
named-tuple field, ``['key']`` for a dict key, ``[0]`` for a sequence
index.  The port's states carry the JAX package's field names, so an
archive that either package writes restores into the other (a calibration's
Adam state crosses through ``utils.convert.adam_state_to_reference`` and
``adam_state_from_reference``).

The JAX package's orbax directory form is a JAX library: a directory path
raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """[(key string, child)] of a node, or None for a leaf.  Dict keys are
    sorted, as JAX sorts them."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if _is_namedtuple(tree):
        return [(f".{k}", getattr(tree, k)) for k in tree._fields]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _rebuild(tree, children: list):
    """A node like ``tree`` with its children replaced, in order."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: v for f, v in zip(dataclasses.fields(tree), children)})
    if _is_namedtuple(tree):
        return type(tree)(*children)
    if isinstance(tree, dict):
        return {**tree, **dict(zip(sorted(tree), children))}
    return type(tree)(children)


def flatten_with_paths(tree: Any, prefix: str = ""):
    """[(key path, leaf)] of a state, in the JAX package's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += flatten_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def _map_leaves(tree: Any, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [
        _map_leaves(child, fn, f"{prefix}/{key}" if prefix else key)
        for key, child in kids])


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, *, use_orbax: bool = False) -> str:
    """Write ``tree`` as an ``.npz`` archive of its leaves by key path
    (``.npz`` is appended when missing).  Returns the written path.
    ``use_orbax=True`` (the JAX package's directory form) is refused."""
    if use_orbax:
        raise ValueError("orbax checkpoints are a JAX library's format; the "
                         "port writes the .npz form (use_orbax=False)")
    if not path.endswith(".npz"):
        path = path + ".npz"
    flat = flatten_with_paths(tree)
    arrays = {f"leaf_{i}": _to_numpy(v) for i, (_, v) in enumerate(flat)}
    arrays["__paths__"] = np.asarray(json.dumps([p for p, _ in flat]))
    np.savez(path, **arrays)
    return path


def _cast(arr: np.ndarray, ref):
    """An archived array as the template leaf's type: a tensor of its dtype
    on its device (trainable if the template leaf is), a numpy array of its
    dtype, or the array itself for any other leaf."""
    if isinstance(ref, torch.Tensor):
        out = torch.as_tensor(np.asarray(arr)).to(device=ref.device,
                                                  dtype=ref.dtype)
        return out.requires_grad_() if ref.requires_grad else out
    if isinstance(ref, np.ndarray):
        return np.asarray(arr).astype(ref.dtype)
    return arr


def restore(path: str, like: Any, *, partial: bool = False) -> Any:
    """Restore an archive into the structure of ``like`` (a template state
    with the right shapes, dtypes and devices).

    Leaves are matched BY KEY PATH, so an archive saved under another state
    structure (a plain stream state resumed into a tracked-stream template)
    raises ``ValueError`` naming the mismatch instead of assigning leaves by
    index.  ``partial=True`` instead keeps the template's value for leaves
    missing from the archive and ignores archived extras.  Each restored
    leaf takes the template leaf's dtype and device."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint, which the JAX "
            "package writes through a JAX library; save it as .npz there "
            "(use_orbax=False) to restore it here")
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    flat_like = flatten_with_paths(like)
    if "__paths__" in data:
        saved_paths = json.loads(str(data["__paths__"]))
        by_path = {p: data[f"leaf_{i}"] for i, p in enumerate(saved_paths)}
        like_paths = [p for p, _ in flat_like]
        like_set = set(like_paths)
        missing = [p for p in like_paths if p not in by_path]
        extra = [p for p in saved_paths if p not in like_set]
        if (missing or extra) and not partial:
            raise ValueError(
                f"checkpoint structure mismatch for {path}: "
                f"{len(missing)} template leaves not in archive "
                f"(e.g. {missing[:3]}), {len(extra)} archived leaves not "
                f"in template (e.g. {extra[:3]}); pass partial=True to "
                f"restore the intersection")
        return _map_leaves(like, lambda p, ref: (
            _cast(by_path[p], ref) if p in by_path else ref))

    # legacy archive without key paths: positional match, guarded
    n_saved = len([k for k in data.files if k.startswith("leaf_")])
    if n_saved != len(flat_like):
        raise ValueError(
            f"checkpoint {path} has {n_saved} leaves but the template "
            f"expects {len(flat_like)} — saved under a different "
            f"configuration")
    index = {p: i for i, (p, _) in enumerate(flat_like)}
    return _map_leaves(like, lambda p, ref: _cast(data[f"leaf_{index[p]}"],
                                                  ref))
