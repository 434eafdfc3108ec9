"""Plain reference of the paper's CNN family (VGG-A): parameters, inputs,
the loss, and the products of a forward pass.

Written from the published architecture in plain PyTorch, independent of
the program: the convolutions are ``F.conv2d`` on NCHW views, the pools
``F.max_pool2d``, the classifier ``x @ w + b`` and the loss
``F.cross_entropy``.  The parameter tree is the one both sides are handed:
NHWC activations, HWIO conv weights and (in, out) FC weights under the
keys ``conv02_w``, ``fc13_b`` (the layer's zero-padded index), so that the
sorted key order is the layer order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BATCH_SEED_OFFSET = 2 ** 62     # the inputs' generator, apart from the weights'


def param_shapes(cfg: dict) -> dict:
    """Key -> shape of every leaf, in layer order."""
    out = {}
    for i, lyr in enumerate(cfg["layers"]):
        if lyr["kind"] == "conv":
            k = lyr["kernel"]
            out[f"conv{i:02d}_w"] = (k, k, lyr["ifm"], lyr["ofm"])
            out[f"conv{i:02d}_b"] = (lyr["ofm"],)
        elif lyr["kind"] == "fc":
            out[f"fc{i:02d}_w"] = (lyr["ifm"], lyr["ofm"])
            out[f"fc{i:02d}_b"] = (lyr["ofm"],)
    return out


def _std(key: str, shape, last: str) -> float:
    fan_in = math.prod(shape[:-1])
    return math.sqrt((1.0 if key == last else 2.0) / fan_in)


def init_params(cfg: dict, seed: int, device) -> dict:
    """Every weight from one ``randn`` call on ``device`` seeded with
    ``seed``, scaled leaf by leaf (``assumed`` in the configuration);
    biases zero."""
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
        out[key] = flat[off:off + n].view(shape) * _std(key, shape,
                                                        weights[-1])
        off += n
    return out


def make_batches(cfg: dict, batch: int, count: int, seed: int, device
                 ) -> list:
    """``count`` distinct global batches of ``batch`` NHWC images and
    labels, drawn on ``device`` from ``seed`` in two calls."""
    gen = torch.Generator(device=device).manual_seed(seed + BATCH_SEED_OFFSET)
    s = cfg["image_size"]
    images = torch.randn(count, batch, s, s, 3, generator=gen, device=device)
    labels = torch.randint(0, cfg["num_classes"], (count, batch),
                           generator=gen, device=device)
    return [{"images": images[i], "labels": labels[i]} for i in range(count)]


def loss(params: dict, cfg: dict, batch: dict) -> torch.Tensor:
    """Mean softmax cross-entropy of the forward pass."""
    h = batch["images"].permute(0, 3, 1, 2)           # NCHW view
    layers = cfg["layers"]
    for i, lyr in enumerate(layers):
        if lyr["kind"] == "conv":
            w = params[f"conv{i:02d}_w"].permute(3, 2, 0, 1)   # OIHW
            h = F.relu(F.conv2d(h, w, params[f"conv{i:02d}_b"],
                                stride=lyr["stride"], padding=lyr["pad"]))
        elif lyr["kind"] == "pool":
            h = F.max_pool2d(h, 2, 2)
        else:
            if h.dim() == 4:                          # flatten as (H, W, C)
                h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
            h = h @ params[f"fc{i:02d}_w"] + params[f"fc{i:02d}_b"]
            if i != len(layers) - 1:
                h = F.relu(h)
    return F.cross_entropy(h, batch["labels"])


def products(cfg: dict) -> list:
    """The forward pass's products for one sample: ("conv", H, W, Ci, Co,
    k, stride, pad) per convolution and ("fc", 1, K, N) per classifier
    layer; ``bench/flops.py`` counts them."""
    out, hw = [], cfg["image_size"]
    for lyr in cfg["layers"]:
        if lyr["kind"] == "conv":
            out.append(("conv", hw, hw, lyr["ifm"], lyr["ofm"], lyr["kernel"],
                        lyr["stride"], lyr["pad"]))
        elif lyr["kind"] == "fc":
            out.append(("fc", 1, lyr["ifm"], lyr["ofm"]))
        hw = lyr.get("out_hw", hw)
    return out
