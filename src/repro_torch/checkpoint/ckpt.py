"""Checkpointing (``repro.checkpoint.ckpt``): flattened-tree npz + JSON
manifest, in the reference's file format, so that either package reads the
other's files.

A checkpoint of step ``s`` in a directory is two files:

    ckpt_{s:08d}.json   the manifest ``{"step", "trees", "meta"}``: per tree
                        name its leaf keys in leaf order, and the caller's
                        ``meta`` (the zero1 world layout, for a re-plan at
                        another world size: ``checkpoint.replan``)
    ckpt_{s:08d}.npz    one array per leaf, keyed ``name:path``

A leaf's path is the reference's ``_key_str`` of its
``jax.tree_util.tree_flatten_with_path`` path: dict keys (visited in sorted
order), NamedTuple field names and list or tuple indices, joined by ``/``.
So a momentum-SGD strip leaf is ``opt_state:velocity/3`` and a top-k
residual ``opt_state:residual/3`` beside ``opt_state:zero1/velocity/3``.
Every leaf is written in its own dtype; AdamW's ``count``, a Python int in
the port, is written as the reference holds it, a 0-d ``int32``, and read
back to an int.  A leaf numpy cannot hold (bfloat16) raises.

Every leaf is written as the reference writes it, at its global shape:
the zero1 strip state one ``(G, n/G)`` array per bucket in owner order, a
model-sharded param or zero1-gspmd state leaf at its full shape.  A run
holds some leaves otherwise (a process mesh's rank its own strip row, a
model member its block), so ``save`` takes a ``gather`` per tree
(``api.run.Run._global``: ``launch.mesh``'s ``gather_members``,
``core.sharding.from_members``): a collective that every rank enters for
the same trees in the same order, after which only rank 0 writes, and
every rank returns once it has written.  It
writes the manifest first and the ``.npz`` last, each to a temporary file
moved into place with ``os.replace``: the
``.npz`` is what :func:`latest_step` looks for, so a checkpoint exists
whole or not at all, whenever a worker dies.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

import torch

from repro_torch.core.params import map_tree


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of ``tree`` in ``core.params.map_tree``'s
    order, the path as the reference's ``_key_str`` joins it."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return [x for f, t in zip(tree._fields, tree)
                for x in leaves_with_paths(t, prefix + (f,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in leaves_with_paths(t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def np_dtype(dtype) -> np.dtype:
    """numpy's dtype for a leaf's dtype (torch or numpy); raises for one
    numpy cannot hold, rather than widen it in silence."""
    if isinstance(dtype, torch.dtype):
        try:
            return torch.empty((), dtype=dtype).numpy().dtype
        except TypeError:
            raise ValueError(
                f"a checkpoint leaf of dtype {dtype} cannot be written: "
                "numpy has no such dtype") from None
    return np.dtype(dtype)


def leaf_meta(leaf) -> Tuple[Tuple[int, ...], np.dtype]:
    """(shape, numpy dtype) of a leaf as the file holds it: a Python int
    (AdamW's count) is a 0-d int32."""
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return (), np.dtype(np.int32)
    return tuple(int(d) for d in leaf.shape), np_dtype(leaf.dtype)


def to_host(leaf) -> np.ndarray:
    """A leaf's value as a host array in its own dtype."""
    if isinstance(leaf, torch.Tensor):
        np_dtype(leaf.dtype)
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _path(directory: str, step: int, ext: str) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.{ext}")


def is_writer() -> bool:
    """True in the process that writes checkpoints: rank 0 of an
    initialised process group, or the only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save(directory: str, step: int, meta: Optional[Dict[str, Any]] = None,
         gather: Optional[Mapping[str, Callable]] = None, **trees) -> str:
    """Write ``trees`` (name=tree) as checkpoint ``step`` of ``directory``
    and return the ``.npz`` path.  ``gather`` maps a tree name to a
    function that turns the tree into its global value (a collective on a
    process mesh: every rank calls ``save`` with the same trees); only rank
    0 then writes, and in an initialised group no rank returns before the
    checkpoint is committed."""
    payload: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"step": step, "trees": {},
                                "meta": meta or {}}
    for name, tree in trees.items():
        fn = (gather or {}).get(name)
        if fn is not None:
            tree = fn(tree)
        keys = []
        for path, leaf in leaves_with_paths(tree):
            k = f"{name}:{path}"
            payload[k] = to_host(leaf)
            keys.append(k)
        manifest["trees"][name] = keys
    path = _path(directory, step, "npz")
    if is_writer():
        os.makedirs(directory, exist_ok=True)
        # manifest first, npz last: the .npz is what latest_step keys on, so
        # its appearance commits the checkpoint
        mpath = _path(directory, step, "json")
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(mpath + ".tmp", mpath)
        np.savez(path + ".tmp.npz", **payload)
        os.replace(path + ".tmp.npz", path)
    _committed()
    return path


def _committed() -> None:
    """Hold every rank of an initialised group until rank 0 has committed
    the checkpoint: a rank that went on at once could look for it
    (``latest_step``, a resume) before the ``.npz`` is in place, start
    from step 0 while its peers resume, and pair its collectives with
    theirs."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def read_manifest(directory: str, step: int) -> Dict[str, Any]:
    """The checkpoint's JSON manifest (``step``, ``trees``, ``meta``).
    Checkpoints written without meta get an empty ``meta`` dict."""
    with open(_path(directory, step, "json")) as f:
        manifest = json.load(f)
    manifest.setdefault("meta", {})
    return manifest


def _open(directory: str, step: int):
    path = _path(directory, step, "npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return path, np.load(path)


def _leaf(data, path: str, k: str) -> np.ndarray:
    if k not in data.files:
        raise KeyError(
            f"checkpoint {path} has no leaf {k!r} — was the tree "
            f"structure changed since the save?")
    return data[k]


def restore(directory: str, step: int, **templates
            ) -> Tuple[Dict[str, Any], int]:
    """templates: name=tree with the structure, shapes and dtypes to
    restore (tensors, numpy arrays or ints).  Returns ({name: the same tree
    of host numpy arrays}, step).

    Raises ``FileNotFoundError`` for a missing checkpoint, ``KeyError`` for
    a leaf absent from the archive (the tree structure changed since the
    save) and ``ValueError`` on a shape or dtype mismatch."""
    path, data = _open(directory, step)
    out = {}
    with data:
        for name, template in templates.items():
            leaves = []
            for leaf_path, leaf in leaves_with_paths(template):
                k = f"{name}:{leaf_path}"
                arr = _leaf(data, path, k)
                shape, dtype = leaf_meta(leaf)
                if tuple(arr.shape) != shape:
                    raise ValueError(
                        f"checkpoint leaf {k!r} has shape "
                        f"{tuple(arr.shape)}, template expects {shape}")
                if np.dtype(arr.dtype) != dtype:
                    raise ValueError(
                        f"checkpoint leaf {k!r} has dtype "
                        f"{np.dtype(arr.dtype)}, template expects {dtype}")
                leaves.append(arr)
            it = iter(leaves)
            out[name] = map_tree(lambda _: next(it), template)
    return out, step


def restore_loose(directory: str, step: int, name: str,
                  template) -> List[np.ndarray]:
    """The saved leaves of tree ``name`` in ``template``'s leaf order, as
    host arrays with no shape or dtype check: the input to
    ``checkpoint.replan`` when the saved world size differs from the
    current one.  The structure must still match (``KeyError``)."""
    path, data = _open(directory, step)
    with data:
        return [_leaf(data, path, f"{name}:{p}")
                for p, _ in leaves_with_paths(template)]
