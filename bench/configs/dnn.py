"""Plain reference of the paper's fully-connected ASR model (CD-DNN):
parameters, inputs, the loss, and the products of a forward pass.

Written from the published architecture in plain PyTorch, independent of
the program: each layer ``h @ w + b``, a sigmoid on every hidden layer and
``F.cross_entropy`` over the senones.  Keys ``fc00_w`` .. ``fc07_b``, (in,
out) weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BATCH_SEED_OFFSET = 2 ** 62     # the inputs' generator, apart from the weights'


def dims(cfg: dict) -> list:
    return ([cfg["input_dim"]] + [cfg["hidden_dim"]] * cfg["num_hidden"]
            + [cfg["output_dim"]])


def param_shapes(cfg: dict) -> dict:
    d = dims(cfg)
    out = {}
    for i, (a, b) in enumerate(zip(d[:-1], d[1:])):
        out[f"fc{i:02d}_w"] = (a, b)
        out[f"fc{i:02d}_b"] = (b,)
    return out


def init_params(cfg: dict, seed: int, device) -> dict:
    """Every weight from one ``randn`` call on ``device`` seeded with
    ``seed``, scaled by 1 / sqrt(fan_in); biases zero."""
    shapes = param_shapes(cfg)
    weights = [k for k in shapes if k.endswith("_w")]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(shapes[k]) for k in weights),
                       generator=gen, device=device)
    out, off = {}, 0
    for key, shape in shapes.items():
        if key.endswith("_b"):
            out[key] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        out[key] = flat[off:off + n].view(shape) / math.sqrt(shape[0])
        off += n
    return out


def make_batches(cfg: dict, batch: int, count: int, seed: int, device
                 ) -> list:
    """``count`` distinct global batches of ``batch`` frames and senone
    labels, drawn on ``device`` from ``seed`` in two calls."""
    gen = torch.Generator(device=device).manual_seed(seed + BATCH_SEED_OFFSET)
    frames = torch.randn(count, batch, cfg["input_dim"], generator=gen,
                         device=device)
    senones = torch.randint(0, cfg["output_dim"], (count, batch),
                            generator=gen, device=device)
    return [{"frames": frames[i], "senones": senones[i]}
            for i in range(count)]


def loss(params: dict, cfg: dict, batch: dict) -> torch.Tensor:
    """Mean frame cross-entropy over the senones."""
    h = batch["frames"]
    n = cfg["num_hidden"] + 1
    for i in range(n):
        h = h @ params[f"fc{i:02d}_w"] + params[f"fc{i:02d}_b"]
        if i < n - 1:
            h = torch.sigmoid(h)
    return F.cross_entropy(h, batch["senones"])


def products(cfg: dict) -> list:
    """("fc", 1, K, N) per layer, for one frame."""
    d = dims(cfg)
    return [("fc", 1, a, b) for a, b in zip(d[:-1], d[1:])]
