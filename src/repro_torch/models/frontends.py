"""Modality-frontend stubs of the port (``repro.models.frontends``).

As in the reference there is no ViT and no conv audio codec: a vision
model takes pre-computed patch embeddings and an audio model pre-computed
frame embeddings.  These helpers synthesize them for runnable examples and
smoke runs, together with Qwen2-VL's M-RoPE positions and MusicGen's
codebook delay pattern (a data-layout property, not a codec property).

The stubs draw from an explicit ``torch.Generator``, so their bits are not
the reference's ``jax.random`` draws; the data pipeline's ``vlm_stream`` and
``audio_stream`` draw from numpy instead and match the reference bitwise.
``mrope_positions`` and ``delay_pattern`` are plain integer arithmetic in
numpy and equal the reference's exactly.
"""
from __future__ import annotations

import numpy as np

import torch


def vision_stub_embeds(gen: torch.Generator, batch: int, n_tokens: int,
                       d_model: int, dtype=torch.float32) -> torch.Tensor:
    """Stand-in for ViT+projector output: (B, n_tokens, d_model) on
    ``gen``'s device."""
    return torch.randn((batch, n_tokens, d_model), generator=gen,
                       dtype=dtype, device=gen.device) * 0.02


def mrope_positions(batch: int, s_img: int, s_txt: int,
                    grid_w: int = 32) -> np.ndarray:
    """Qwen2-VL M-RoPE positions (B, S, 3) int32 = (t, h, w).  Image
    patches: t = 0, (h, w) from the patch grid; text tokens: all three
    components advance together starting after the image span."""
    hh = np.arange(s_img) // grid_w
    ww = np.arange(s_img) % grid_w
    img = np.stack([np.zeros(s_img, np.int64), hh, ww], axis=-1)
    start = max(hh[-1], ww[-1]) + 1 if s_img else 0
    txt1 = start + np.arange(s_txt)
    txt = np.stack([txt1, txt1, txt1], axis=-1)
    pos = np.concatenate([img, txt], axis=0).astype(np.int32)
    return np.broadcast_to(pos[None], (batch, s_img + s_txt, 3))


def audio_stub_embeds(gen: torch.Generator, batch: int, seq: int,
                      d_model: int, dtype=torch.float32) -> torch.Tensor:
    """Stand-in for summed EnCodec codebook embeddings: (B, S, d_model)
    on ``gen``'s device."""
    return torch.randn((batch, seq, d_model), generator=gen, dtype=dtype,
                       device=gen.device) * 0.02


def delay_pattern(tokens: np.ndarray, n_codebooks: int,
                  pad_id: int = 0) -> np.ndarray:
    """MusicGen delay interleave: codebook k is shifted right by k steps.
    tokens: (B, S, K) -> delayed (B, S, K), the same dtype."""
    B, S, K = tokens.shape
    if K != n_codebooks:
        raise ValueError(f"{K} codebooks in the tokens, {n_codebooks} asked")
    out = np.full_like(tokens, pad_id)
    for k in range(K):
        out[:, k:, k] = tokens[:, :S - k, k]
    return out
