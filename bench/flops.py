"""Operations and bytes of the products a forward pass makes, from the
configuration's shapes alone (``products`` of each family's reference),
and the least time the card's peaks allow for them.

A convolution counts 2 * N * Ho * Wo * Co * Ci * k^2 operations (one
multiply and one add per tap, the direct algorithm, whatever implements
it) and each f32 input, weight and output byte once; a product (M, K) @
(K, N) counts 2 * M * K * N and its three operands once.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())
F32 = 4


def cost(product: tuple, batch: int) -> tuple:
    """(operations, bytes) of one ``product`` over ``batch`` samples."""
    if product[0] == "conv":
        _, h, w, ci, co, k, s, pad = product
        ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
        return (2 * batch * ho * wo * co * ci * k * k,
                F32 * (batch * h * w * ci + k * k * ci * co
                       + batch * ho * wo * co))
    _, rows, k, n = product
    m = batch * rows
    return 2 * m * k * n, F32 * (m * k + k * n + m * n)


def least_seconds(product: tuple, batch: int, peaks: dict = PEAKS) -> float:
    """The larger of the operations at the dense TF32 rate (the fastest
    the card multiplies f32 inputs) and the bytes at the HBM rate."""
    ops, nbytes = cost(product, batch)
    return max(ops / peaks["tf32_flop_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def forward_ops(products: list, batch: int, kind=None) -> int:
    """Operations of the forward products (of ``kind`` only, if given)."""
    return sum(cost(p, batch)[0] for p in products
               if kind is None or p[0] == kind)


def model_ops_per_step(products: list, batch: int) -> int:
    """Model operations of a training step: the forward's products and
    the backward's two of each, nothing recomputed counted."""
    return 3 * forward_ops(products, batch)
