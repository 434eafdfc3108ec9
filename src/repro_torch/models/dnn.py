"""CD-DNN (paper §5.4): the 7 x 2048 fully-connected ASR acoustic model in
PyTorch (``repro.models.dnn``).

Weights are laid out (in, out), as in the reference, so parameters carry
across from the JAX package with no transpose.  Each layer's product
``h @ W`` is a plain ``@`` or, with ``use_kernel=True``, the Hopper blocked
GEMM's autograd wrapper ``kernels.blocked_matmul.matmul``; the bias add and
the sigmoid stay PyTorch, as in the reference.

Under a model axis (``ctx``, ``core.sharding.ShardingCtx``) every layer's
weight and bias shard their output ("ff") dim: each model member runs the
product on its own contiguous block of columns (one GEMM launch a member
on the kernel route) and ``gather_model`` joins the blocks, where the
reference constrains the activation to ``("batch", "ff")``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import DNNConfig
from repro_torch.core.params import Spec, init_tree
from repro_torch.core.sharding import ShardingCtx
from repro_torch.device import resolve_device
from repro_torch.kernels import blocked_matmul as kmm


def param_specs(cfg: DNNConfig) -> Dict[str, Spec]:
    dims = [cfg.input_dim] + [cfg.hidden_dim] * cfg.num_hidden \
        + [cfg.output_dim]
    # layer-major zero-padded keys: the sorted key order every tree walk
    # uses is the forward layer order, each bias beside its weight — the
    # order of the comm bucket plan
    sp: Dict[str, Spec] = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sp[f"fc{i:02d}_w"] = Spec((a, b), ("embed", "ff"))
        sp[f"fc{i:02d}_b"] = Spec((b,), ("ff",), init="zeros")
    return sp


def init_params(cfg: DNNConfig, seed: int = 0, device=None
                ) -> Dict[str, torch.Tensor]:
    """Fresh params on ``device`` (default: the GPU), drawn from a
    ``torch.Generator`` seeded with ``seed``: the reference's distributions,
    not its bits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_tree(param_specs(cfg), gen, dev)


def forward(params, cfg: DNNConfig, x: torch.Tensor,
            use_kernel: bool = False,
            ctx: ShardingCtx = ShardingCtx()) -> torch.Tensor:
    """x: (N, input_dim) frames -> logits (N, output_dim); sigmoid on every
    hidden layer, none on the last.  ``params`` in ``ctx``'s member
    layout."""
    specs = param_specs(cfg)

    def layer(x, w, b):
        return (kmm.matmul(x, w) if use_kernel else x @ w) + b

    h = x
    n_layers = cfg.num_hidden + 1
    for i in range(n_layers):
        keys = (f"fc{i:02d}_w", f"fc{i:02d}_b")
        h = ctx.column(h, [params[k] for k in keys],
                       [specs[k] for k in keys], layer)
        if i < n_layers - 1:
            h = torch.sigmoid(h)        # CD-DNN uses sigmoid hidden units
    return h


def loss_fn(params, cfg: DNNConfig, batch: dict,
            use_kernel: bool = False,
            ctx: ShardingCtx = ShardingCtx()) -> torch.Tensor:
    """Mean frame cross-entropy over senones, ``logsumexp - logit[senone]``."""
    lf = forward(params, cfg, batch["frames"], use_kernel, ctx).float()
    sen = batch["senones"].long()[:, None]
    nll = torch.logsumexp(lf, -1) - lf.gather(-1, sen)[:, 0]
    return nll.mean()
