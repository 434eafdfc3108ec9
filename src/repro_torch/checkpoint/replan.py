"""Re-plan zero1 strip optimizer state for another world size
(``repro.checkpoint.replan``), on host numpy arrays.

A checkpoint saved at G=8 holds strip leaves shaped (8, padded8/8) that a
G=4 run cannot load by shape.  The §3.4 strip decomposition makes the
conversion exact:

  * bucket boundaries do not depend on G: ``comm.bucketer.plan_buckets``
    closes buckets on byte capacity and dtype runs over the param tree, so
    both worlds agree on which elements each bucket holds; only
    ``padded_size`` (rounded up to a multiple of G) differs;
  * the pad tail holds zeros for ever (zero at init, a structurally zero
    gradient there, and recurrences that keep zero at zero), so truncating
    the old pad and zero-filling the new one loses nothing;
  * under the hierarchical schedule rows sit in owner order
    (``optim.dist.owner_perm``): unpermute to value order, reslice, apply
    the new world's permutation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.checkpoint.ckpt import leaf_meta
from repro_torch.comm.bucketer import BucketPlan
from repro_torch.core.collectives import padded_size
from repro_torch.core.params import map_tree, tree_leaves
from repro_torch.optim.dist import owner_perm


def world_meta(axes_sizes: Sequence[int], hierarchical: bool,
               bucket_bytes: int) -> Dict:
    """The JSON record ``ckpt.save`` stores under ``meta["zero1"]``: what
    :func:`replan_strip_state` needs to undo the saved layout."""
    sizes = [int(s) for s in axes_sizes]
    g = 1
    for s in sizes:
        g *= s
    return {"G": g, "axes_sizes": sizes, "hierarchical": bool(hierarchical),
            "bucket_bytes": int(bucket_bytes)}


def _perm(world: Dict) -> Optional[np.ndarray]:
    return owner_perm(world["hierarchical"], world["axes_sizes"])


def replan_strip_leaf(arr: np.ndarray, payload: int, old_world: Dict,
                      new_world: Dict) -> np.ndarray:
    """One (G_old, padded_old/G_old) strip leaf -> (G_new,
    padded_new/G_new).  ``payload`` is the bucket's real element count (the
    same in both worlds); what lies beyond it is the always-zero pad."""
    g_old, g_new = old_world["G"], new_world["G"]
    if arr.ndim != 2 or arr.shape[0] != g_old:
        raise ValueError(
            f"strip leaf has shape {arr.shape}, expected ({g_old}, n) "
            f"for the saved world size {g_old}")
    if arr.size != padded_size(payload, g_old):
        raise ValueError(
            f"strip leaf holds {arr.size} elements, bucket payload "
            f"{payload} at G={g_old} implies {padded_size(payload, g_old)} "
            "— bucket plans disagree (different bucket_bytes or params?)")
    p_old = _perm(old_world)
    if p_old is not None:
        # stored row j is strip p_old[j]; argsort inverts to value order
        arr = arr[np.argsort(p_old)]
    out = np.zeros(padded_size(payload, g_new), dtype=arr.dtype)
    out[:payload] = arr.reshape(-1)[:payload]
    out = out.reshape(g_new, -1)
    p_new = _perm(new_world)
    return out if p_new is None else out[p_new]


def replan_strip_state(template_state, old_leaves: List[np.ndarray],
                       plan: BucketPlan, old_world: Dict, new_world: Dict):
    """The saved opt_state ``old_leaves`` (the old world's shapes, in leaf
    order) in ``template_state``'s structure and the new world's strip
    shapes, as host arrays.

    The structure does not depend on the world size (same optimizer, same
    bucket count), so leaves pair up by position.  Template leaves of rank
    >= 2 are strip tensors, cycling through the buckets in plan order (the
    state is field-major: velocity[b0], velocity[b1], ..., or mu[b0], ...,
    nu[b0], ...); every other leaf (AdamW's count) passes through."""
    if old_world.get("bucket_bytes") != new_world.get("bucket_bytes"):
        raise ValueError(
            f"cannot replan across bucket_bytes change: checkpoint has "
            f"{old_world.get('bucket_bytes')}, run has "
            f"{new_world.get('bucket_bytes')} (bucket boundaries are only "
            "G-independent for a fixed byte capacity)")
    flat_tpl = tree_leaves(template_state)
    if len(flat_tpl) != len(old_leaves):
        raise ValueError(
            f"opt_state has {len(flat_tpl)} leaves, checkpoint has "
            f"{len(old_leaves)} — tree structure changed since the save")
    payloads = [b.size for b in plan.buckets]
    out = []
    strip_i = 0
    for tpl, old in zip(flat_tpl, old_leaves):
        old = np.asarray(old)
        shape, dtype = leaf_meta(tpl)
        if len(shape) >= 2:
            new = replan_strip_leaf(old, payloads[strip_i % len(payloads)],
                                    old_world, new_world)
            strip_i += 1
            if new.shape != shape:
                raise ValueError(
                    f"replanned strip has shape {new.shape}, template "
                    f"expects {shape}")
            out.append(new.astype(dtype))
        else:
            out.append(old.reshape(shape))
    if strip_i and strip_i % len(payloads):
        raise ValueError(
            f"saw {strip_i} strip leaves for {len(payloads)} buckets — "
            "state fields are not whole multiples of the bucket count")
    it = iter(out)
    return map_tree(lambda _: next(it), template_state)
