"""Data pipeline of the port (``repro.data.pipeline``): the paper's §4 data
handling module.

A background thread fills a bounded queue with host-side numpy batches
(double buffering); the consumer places each batch on the run's device as
it takes it.  The synthetic streams are the reference's, draw for draw from
``np.random.default_rng(seed)``, so both packages see bitwise the same
batches.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

import torch


def lm_token_stream(vocab: int, batch: int, seq: int,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-ish token stream: a learnable bigram structure, each token
    replaced by a uniform draw with probability 0.15."""
    rng = np.random.default_rng(seed)
    V = int(vocab)
    shift = rng.integers(1, V, size=()).item()
    while True:
        first = rng.integers(0, V, size=(batch, 1))
        noise = rng.random((batch, seq - 1)) < 0.15
        toks = [first]
        for t in range(1, seq):
            nxt = (toks[-1] * 31 + shift) % V
            rand = rng.integers(0, V, size=(batch, 1))
            toks.append(np.where(noise[:, t - 1: t], rand, nxt))
        yield {"tokens": np.concatenate(toks, axis=1).astype(np.int32)}


def image_stream(image_size: int, num_classes: int, batch: int,
                 seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Images whose class determines a planted frequency pattern."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    while True:
        labels = rng.integers(0, num_classes, size=(batch,))
        freq = (labels[:, None, None] + 1).astype(np.float32)
        base = np.sin(freq * xx[None] / image_size * 6.28) \
            + np.cos(freq * yy[None] / image_size * 6.28)
        img = base[..., None] + 0.3 * rng.standard_normal(
            (batch, image_size, image_size, 3)).astype(np.float32)
        yield {"images": img.astype(np.float32),
               "labels": labels.astype(np.int32)}


def asr_frame_stream(input_dim: int, num_senones: int, batch: int,
                     seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Acoustic frames: a fixed random prototype per senone plus noise."""
    rng = np.random.default_rng(seed)
    proto = rng.standard_normal((num_senones, input_dim)).astype(np.float32)
    while True:
        sen = rng.integers(0, num_senones, size=(batch,))
        frames = proto[sen] + 0.5 * rng.standard_normal(
            (batch, input_dim)).astype(np.float32)
        yield {"frames": frames.astype(np.float32),
               "senones": sen.astype(np.int32)}


def vlm_stream(cfg, batch: int, seq_txt: int,
               seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Vision-language batches: ``lm_token_stream`` text tokens, stub patch
    embeddings of ``cfg.vision_tokens`` rows (0.02 x standard normals from
    a second ``default_rng(seed)``) and the M-RoPE positions of the image
    grid followed by the text (the same array every batch)."""
    from repro_torch.models.frontends import mrope_positions
    rng = np.random.default_rng(seed)
    lm = lm_token_stream(cfg.vocab_size, batch, seq_txt, seed)
    s_img = cfg.vision_tokens
    grid_w = max(1, int(np.sqrt(s_img)))
    # a copy: the broadcast view is read-only, and torch.from_numpy wants
    # writable memory
    pos = np.array(mrope_positions(batch, s_img, seq_txt, grid_w=grid_w))
    while True:
        toks = next(lm)["tokens"]
        emb = 0.02 * rng.standard_normal(
            (batch, s_img, cfg.d_model)).astype(np.float32)
        yield {"tokens": toks, "patch_embeds": emb, "positions": pos}


def audio_stream(cfg, batch: int, seq: int,
                 seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Audio batches: ``cfg.num_codebooks`` codebook token streams (one
    ``lm_token_stream`` of seq x K tokens a row, reshaped) in the delay
    pattern, and stub frame embeddings from a second ``default_rng(seed)``."""
    from repro_torch.models.frontends import delay_pattern
    rng = np.random.default_rng(seed)
    K = cfg.num_codebooks
    lm = lm_token_stream(cfg.vocab_size, batch, seq * K, seed)
    while True:
        toks = next(lm)["tokens"].reshape(batch, seq, K)
        delayed = delay_pattern(toks, K)
        emb = 0.02 * rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)
        yield {"frame_embeds": emb,
               "codebook_labels": delayed.astype(np.int32)}


_SENTINEL = object()    # queued when the source is exhausted: a finite
#                         source must end the consumer's iteration, not
#                         leave it blocked on an empty queue forever


def _to_tensors(batch) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch with a bounded queue (double buffering).

    Finite sources terminate cleanly: exhaustion enqueues a sentinel that
    ``__next__`` turns into ``StopIteration``.  A source that raises is not
    exhaustion: ``__next__`` re-raises its exception.  ``close()`` stops the
    worker, drains the queue and joins the thread (bounded), so no worker is
    left blocked on a full queue after the consumer goes away."""

    def __init__(self, source: Iterator, depth: int = 2,
                 place: Optional[Callable] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._place = place or _to_tensors
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None

        def _put(item) -> bool:
            # bounded put that gives up when close() intervenes, so the
            # worker can never deadlock against a full queue
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in source:
                    if not _put(item):
                        return
            except BaseException as e:     # noqa: BLE001 — must cross threads
                # a crashed pipeline is NOT exhaustion: record the exception
                # so the consumer re-raises it instead of quietly stopping
                self._error = e
            finally:
                _put(_SENTINEL)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            try:                      # keep raising on subsequent calls
                self._q.put_nowait(_SENTINEL)
            except queue.Full:
                pass
            if self._error is not None:
                raise self._error
            raise StopIteration
        return self._place(item)

    def close(self):
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=5.0)


def make_placer(device, shard: Optional[Tuple[int, int]] = None
                ) -> Callable:
    """numpy batch -> dict of tensors on ``device``.  ``shard = (r, G)``
    (a process mesh's ``batch_shard``: r the rank's data-group index, G the
    data extent; a cluster mesh's: r the rank's pod, G the pods, its
    members sharing the rows) keeps rows ``[r*B/G, (r+1)*B/G)`` of every
    array, as the reference shards the batch over its data axes
    (``make_placer``'s ``"batch"`` rule): every rank draws the same seeded
    global batch and keeps its data group's rows, the same rows as the
    other model members of its group.  A ``G`` that does not divide the
    batch raises."""
    dev = torch.device(device)

    def place(batch):
        if shard is not None:
            r, G = shard
            B = len(next(iter(batch.values())))
            if B % G:
                raise ValueError(f"a batch of {B} rows does not split over "
                                 f"{G} ranks")
            batch = {k: v[r * B // G:(r + 1) * B // G]
                     for k, v in batch.items()}
        return {k: t.to(dev) for k, t in _to_tensors(batch).items()}
    return place
