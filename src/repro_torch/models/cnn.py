"""The paper's CNN workloads (VGG-A, OverFeat-FAST) in PyTorch, NHWC
(``repro.models.cnn``).

Activations stay NHWC and weights HWIO, as in the reference, so parameters
carry across from the JAX package with no transpose.  The forward convs run
through ``kernels.ref.conv2d_ref`` (one ``F.conv2d`` call, the reference's
``lax.conv`` route) or, with ``use_kernel=True`` (the reference's
``use_pallas``), through the Hopper direct-conv kernel's autograd wrapper
``kernels.conv2d.conv2d``.

Under a model axis (``ctx``, ``core.sharding.ShardingCtx``) each conv and
FC layer shards its output ("ff") dim: each model member convolves with its
own contiguous block of output channels (one conv launch a member on the
kernel route), and ``gather_model`` joins the blocks along the channel
dim, where the reference constrains the activation to ``("batch", None,
None, "ff")``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import CNNConfig
from repro_torch.core.params import Spec, init_tree
from repro_torch.core.sharding import ShardingCtx
from repro_torch.device import resolve_device
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels.ref import conv2d_ref


def _key(kind: str, i: int, part: str) -> str:
    """Zero-padded layer index, so the sorted key order every tree walk
    uses (``core.params.map_tree``, the reference's ``jax.tree``) is the
    forward layer order: conv02 sorts before conv10."""
    return f"{kind}{i:02d}_{part}"


def param_specs(cfg: CNNConfig) -> Dict[str, Spec]:
    sp: Dict[str, Spec] = {}
    for i, lyr in enumerate(cfg.layers):
        if lyr.kind == "conv":
            sp[_key("conv", i, "w")] = Spec(
                (lyr.kernel, lyr.kernel, lyr.ifm, lyr.ofm),
                ("kernel", "kernel", "embed", "ff"))
            sp[_key("conv", i, "b")] = Spec((lyr.ofm,), ("ff",),
                                            init="zeros")
        elif lyr.kind == "fc":
            sp[_key("fc", i, "w")] = Spec((lyr.ifm, lyr.ofm),
                                          ("embed", "ff"))
            sp[_key("fc", i, "b")] = Spec((lyr.ofm,), ("ff",), init="zeros")
    return sp


def init_params(cfg: CNNConfig, seed: int = 0, device=None
                ) -> Dict[str, torch.Tensor]:
    """Fresh params on ``device`` (default: the GPU), drawn from a
    ``torch.Generator`` seeded with ``seed``: the reference's distributions,
    not its bits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_tree(param_specs(cfg), gen, dev)


def forward(params, cfg: CNNConfig, x: torch.Tensor,
            use_kernel: bool = False,
            ctx: ShardingCtx = ShardingCtx()) -> torch.Tensor:
    """x: (N, H, W, 3) -> logits (N, num_classes); ``params`` in ``ctx``'s
    member layout."""
    specs = param_specs(cfg)
    h = x
    for i, lyr in enumerate(cfg.layers):
        if lyr.kind == "conv":
            def conv(x, w, b, lyr=lyr):
                y = kconv.conv2d(x, w, lyr.stride, lyr.pad) if use_kernel \
                    else conv2d_ref(x, w, lyr.stride, lyr.pad)
                return torch.relu(y + b)
            keys = (_key("conv", i, "w"), _key("conv", i, "b"))
            h = ctx.column(h, [params[k] for k in keys],
                           [specs[k] for k in keys], conv)
        elif lyr.kind == "pool":
            # 2x2 stride-2 VALID max pool on a channels-last view; like
            # lax.reduce_window's gradient, a tie's gradient goes to one input
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2) \
                .permute(0, 2, 3, 1).contiguous()
        elif lyr.kind == "fc":
            if h.dim() == 4:
                h = h.reshape(h.shape[0], -1)      # NHWC: (H, W, C) order
            keys = (_key("fc", i, "w"), _key("fc", i, "b"))
            h = ctx.column(h, [params[k] for k in keys],
                           [specs[k] for k in keys],
                           lambda x, w, b: x @ w + b)
            if i != len(cfg.layers) - 1:
                h = torch.relu(h)
    return h


def loss_fn(params, cfg: CNNConfig, batch: dict,
            use_kernel: bool = False,
            ctx: ShardingCtx = ShardingCtx()) -> torch.Tensor:
    """Mean softmax cross-entropy, ``logsumexp - logit[label]``."""
    lf = forward(params, cfg, batch["images"], use_kernel, ctx).float()
    label = batch["labels"].long()[:, None]
    nll = torch.logsumexp(lf, -1) - lf.gather(-1, label)[:, 0]
    return nll.mean()
