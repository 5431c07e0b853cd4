"""Checkpointing: atomic, step-tagged save and restore in the JAX package's
on-disk layout, so either package restores the other's checkpoint.

A port of the JAX package's `checkpoint/checkpoint.py`. Layout per step:

    <dir>/step_000000123.tmp-<nonce>/   (write)
    <dir>/step_000000123/               (atomic rename commit)
        manifest.json                   (step; each leaf's path, shape, dtype)
        arr_<i>.npy                     (one file a leaf)

A tree is nested dicts, lists, tuples and NamedTuples with array leaves
(numpy arrays, tensors or scalars; None is no leaf). Its leaves are
numbered in JAX's flatten order (dict keys sorted, sequences and NamedTuple
fields in order) and each `path` is the string `jax.tree_util.keystr`
gives it (`.opt.mu['embed']`, `['segments'][0][1]['attn']['wq']`). A
train state goes through `convert.train_state_to_jax` first, which stacks
each segment position's layers over its repeats as the reference holds them.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import uuid
from typing import Iterator

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, path: str = "") -> Iterator[tuple[str, object]]:
    """(keystr path, leaf) in JAX's flatten order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], f"{path}[{key!r}]")
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from leaves_with_paths(getattr(tree, field), f"{path}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _rebuild(like, leaves: Iterator):
    """`like`'s structure with its leaves taken from `leaves` in flatten order."""
    if isinstance(like, dict):
        built = {key: _rebuild(like[key], leaves) for key in sorted(like)}
        return {key: built[key] for key in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _step_dir(ckpt_dir, step: int) -> pathlib.Path:
    return pathlib.Path(ckpt_dir) / f"step_{step:09d}"


def save(ckpt_dir: str | os.PathLike, step: int, tree) -> pathlib.Path:
    """Write `tree` as step `step`'s checkpoint: into a temporary directory,
    committed by renaming it (a crashed writer leaves no partial step)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = ckpt_dir / f"{final.name}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir()
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
        arr = _array(leaf)
        np.save(tmp / f"arr_{i}.npy", arr)
        manifest["leaves"].append({"path": path, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def _committed_steps(ckpt_dir: pathlib.Path) -> list[int]:
    return [int(m.group(1)) for p in ckpt_dir.iterdir() if (m := re.fullmatch(r"step_(\d+)", p.name))]


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    """The newest committed step, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _committed_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str | os.PathLike, step: int, like_tree):
    """Step `step`'s leaves, as numpy arrays, in the structure of
    `like_tree` (whose leaves need only a `.shape`). Raises if the leaf
    count or a shape differs."""
    path = _step_dir(ckpt_dir, step)
    manifest = json.loads((path / "manifest.json").read_text())
    like = list(leaves_with_paths(like_tree))
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"target tree has {len(like)}")
    arrays = []
    for i, ((_, leaf), meta) in enumerate(zip(like, manifest["leaves"])):
        arr = np.load(path / f"arr_{i}.npy")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{meta['path']}: checkpoint shape {arr.shape}, target {tuple(leaf.shape)}")
        arrays.append(arr)
    return _rebuild(like_tree, iter(arrays))


def prune_old(ckpt_dir: str | os.PathLike, keep: int = 3) -> None:
    """Delete all but the newest `keep` committed steps."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    for step in sorted(_committed_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, step))
