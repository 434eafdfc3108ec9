"""The executable product of ``compile_serve``: a continuous-batching server
(``repro.api.serve``).

A :class:`Server` owns everything request serving needs: the page pools of
``max_batch`` slots (one pool per layer, on the device), the host-side
:class:`~repro_torch.serve.kvcache.PagedKVCache` free list the scheduler
admits and preempts against, and the request queue.  The engine loop is
``submit() -> step() -> ... -> drain()``:

``submit``  admission control against the spec's budgets and queue bound.
``step``    one scheduler iteration: admit and prefill newcomers (dense
            causal prefill, packed into their pages), then advance every
            active slot one token through the paged decode step.  If a
            slot's next token needs a page the pool can't provide, the
            YOUNGEST active request is preempted and restarts from the queue
            front.
``drain``   step until queue and slots are empty.

The reference runs prefill and decode as jitted functions whose page pools
are donated buffers.  Here both run eagerly and write the pools IN PLACE,
so the pools never exist twice.  Idle slots point their page-table row at
the reserved null page, and their discarded decode writes land there.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

import torch

from repro_torch.models import layers, transformer
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.telemetry.events import NULL_RECORDER
from repro_torch.telemetry.metrics import Histogram


def _sample(logits: torch.Tensor, temperature: float,
            gen: torch.Generator) -> torch.Tensor:
    """Greedy (temperature <= 0; the first maximum on ties) or categorical
    over (..., V) logits.  Returns int32."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=gen).reshape(
        probs.shape[:-1]).to(torch.int32)


@dataclass
class Request:
    """One generation request and its lifecycle bookkeeping (wall-clock
    times from ``time.perf_counter``; ``None`` until reached)."""
    rid: int
    prompt: np.ndarray                   # (L,) int32
    max_new: int
    submit_t: float
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    preemptions: int = 0
    admit_seq: int = -1                  # admission order (preempt youngest)

    @property
    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def done(self) -> bool:
        return self.finish_t is not None

    @property
    def latency(self) -> Optional[float]:
        return None if self.finish_t is None else self.finish_t - self.submit_t


class Server:
    """An assembled serving deployment (see the module docstring).  Built by
    ``repro_torch.api.assemble.compile_serve``."""

    def __init__(self, spec: Any, cfg: Any, params: Any,
                 device: torch.device, recorder: Any = None):
        self.spec = spec
        self.cfg = cfg
        self.params = params
        self.device = device
        self.telemetry = recorder if recorder is not None else NULL_RECORDER
        # TTFT = submit -> first sampled token, e2e = submit -> finish
        self._lat = {"ttft": Histogram(), "e2e": Histogram()}

        B = spec.max_batch
        n = spec.pages_per_request
        self.alloc = PagedKVCache(spec.num_pages, spec.page_size)
        self._pools = [
            (c.pages_k, c.pages_v) for c in transformer.init_paged_caches(
                cfg, B, spec.num_pages, spec.page_size, n,
                impl=spec.attn_impl, device=device)]
        self._pt = np.zeros((B, n), np.int32)
        self._lengths = np.zeros((B,), np.int32)
        self._last_tok = np.zeros((B,), np.int32)
        self._slots: List[Optional[Request]] = [None] * B
        self._queue: deque = deque()
        self._gen = torch.Generator(device=device).manual_seed(spec.seed)
        self._next_rid = 0
        self._admit_seq = 0
        self.stats = {"steps": 0, "decode_tokens": 0, "prefill_tokens": 0,
                      "preemptions": 0, "completed": 0}

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    @torch.no_grad()
    def decode_logits(self, impl: Optional[str] = None) -> torch.Tensor:
        """One paged decode forward over every slot at its current state:
        writes each slot's k/v at its next position (in place) and returns
        the next-token logits (max_batch, V).  Slot lengths do not advance,
        so calling it again recomputes the same step.  ``impl`` overrides
        ``spec.attn_impl`` ("kernel" or "gather")."""
        impl = impl or self.spec.attn_impl
        R = self.cfg.pattern_repeats
        toks = self._tensor(self._last_tok[:, None])
        lengths = self._tensor(self._lengths)
        pt = self._tensor(self._pt)
        pt_s = pt[None].expand(R, *pt.shape)
        len_s = lengths[None].expand(R, *lengths.shape)
        caches = tuple(layers.PagedKVState(k, v, pt_s, len_s, impl)
                       for (k, v) in self._pools)
        logits, _, _ = transformer.forward(
            self.params, self.cfg, tokens=toks, positions=lengths[:, None],
            caches=caches)
        return logits[:, -1]

    def _bucket(self, length: int) -> int:
        b = self.spec.prefill_bucket
        while b < length:
            b *= 2
        return b

    @torch.no_grad()
    def _prefill(self, toks: np.ndarray, length: int,
                 page_row: np.ndarray) -> int:
        """Dense causal prefill of one padded prompt, packed into the
        request's pages; returns the first sampled token."""
        bucket = toks.shape[1]
        ps, n = self.spec.page_size, self.spec.pages_per_request
        caches = transformer.init_caches(self.cfg, 1, bucket,
                                         device=self.device)
        logits, _, dense = transformer.forward(
            self.params, self.cfg, tokens=self._tensor(toks), caches=caches,
            update_cache=True)
        tok = _sample(logits[:, length - 1], self.spec.temperature,
                      self._gen)[0]
        pos = torch.arange(bucket, device=self.device)
        lp = pos // ps
        row = self._tensor(page_row).long()
        # positions past the page-table span go to the null page; garbage
        # past `length` inside allocated pages is overwritten by decode or
        # masked (pos < length)
        phys = torch.where(lp < n, row[torch.clamp(lp, max=n - 1)], 0)
        off = pos % ps
        for (kp, vp), dc in zip(self._pools, dense):
            C_e = dc.k.shape[2]      # dense ring capacity of this entry
            kp[:, phys, off] = dc.k[:, 0, pos % C_e].to(kp.dtype)
            vp[:, phys, off] = dc.v[:, 0, pos % C_e].to(vp.dtype)
        return int(tok)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None) -> int:
        """Queue one prompt; returns the request id.  Raises RuntimeError
        when admission control rejects (queue at ``max_queue``) and
        ValueError for prompts/budgets beyond the spec."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 1 <= prompt.shape[0] <= self.spec.max_prompt:
            raise ValueError(
                f"prompt length {prompt.shape[0]} outside "
                f"[1, max_prompt={self.spec.max_prompt}]")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt tokens outside [0, vocab_size="
                             f"{self.cfg.vocab_size})")
        max_new = (self.spec.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        if not 1 <= max_new <= self.spec.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {max_new} outside "
                f"[1, max_new_tokens={self.spec.max_new_tokens}]")
        if len(self._queue) >= self.spec.max_queue:
            raise RuntimeError(
                f"admission rejected: queue at max_queue="
                f"{self.spec.max_queue}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid=rid, prompt=prompt, max_new=max_new,
                                   submit_t=time.perf_counter()))
        return rid

    @property
    def active(self) -> List[Request]:
        return [r for r in self._slots if r is not None]

    def step(self) -> List[Request]:
        """One scheduler iteration: admit + prefill newcomers, advance every
        active slot one decode token.  Returns requests completed during
        this step."""
        completed: List[Request] = []
        self._admit(completed)
        if not self.active:
            return completed
        self._ensure_pages()
        active = [(b, r) for b, r in enumerate(self._slots) if r is not None]
        with self.telemetry.span("decode", active=len(active)):
            tok = _sample(self.decode_logits(), self.spec.temperature,
                          self._gen).cpu().numpy()
        self.stats["steps"] += 1
        self.stats["decode_tokens"] += len(active)
        for b, req in active:
            req.tokens.append(int(tok[b]))
            self._lengths[b] += 1
            self._last_tok[b] = tok[b]
            if len(req.tokens) >= req.max_new:
                self._finish(b, req, completed)
        return completed

    def drain(self, max_steps: Optional[int] = None) -> List[Request]:
        """Step until the queue and all slots are empty; returns every
        request completed during the drain."""
        limit = max_steps if max_steps is not None else (
            10_000 + self.spec.max_new_tokens * (
                len(self._queue) + self.spec.max_batch) * 4)
        done: List[Request] = []
        for _ in range(limit):
            if not self._queue and not self.active:
                return done
            done.extend(self.step())
        raise RuntimeError(f"drain did not converge in {limit} steps "
                           f"({len(self._queue)} queued, "
                           f"{len(self.active)} active)")

    # ------------------------------------------------------------------
    # scheduler internals
    # ------------------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for b, r in enumerate(self._slots):
            if r is None:
                return b
        return None

    def _admit(self, completed: List[Request]):
        if self.spec.scheduler == "static" and self.active:
            return                       # wave still running: no admission
        while self._queue:
            slot = self._free_slot()
            if slot is None:
                return
            req = self._queue[0]
            L = len(req.prompt)
            if self.alloc.alloc(req.rid, self.alloc.pages_for(L + 1)) is None:
                return                   # pool can't hold it yet: wait
            self._queue.popleft()
            self._prefill_into(slot, req)
            if len(req.tokens) >= req.max_new:
                self._finish(slot, req, completed)

    def _prefill_into(self, slot: int, req: Request):
        L = len(req.prompt)
        bucket = self._bucket(L)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :L] = req.prompt
        row = self.alloc.page_row(req.rid, self.spec.pages_per_request)
        with self.telemetry.span("prefill", rid=req.rid, tokens=L,
                                 bucket=bucket):
            first = self._prefill(toks, L, row)
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        req.tokens = [first]
        req.first_token_t = time.perf_counter()
        self._slots[slot] = req
        self._pt[slot] = row
        self._lengths[slot] = L
        self._last_tok[slot] = first
        self.stats["prefill_tokens"] += L

    def _ensure_pages(self):
        """Every active slot gets the page its next decode write needs;
        preempt the youngest active request when the pool runs dry."""
        for b in sorted((b for b, r in enumerate(self._slots)
                         if r is not None),
                        key=lambda b: self._slots[b].admit_seq):
            req = self._slots[b]
            if req is None:              # preempted by an earlier iteration
                continue
            need = self.alloc.pages_for(int(self._lengths[b]) + 1)
            while not self.alloc.ensure(req.rid, need):
                victims = [(r.admit_seq, s) for s, r in
                           enumerate(self._slots)
                           if r is not None and s != b]
                if not victims:
                    raise RuntimeError(
                        "page pool exhausted by a single request — "
                        "ServeSpec validation should have prevented this")
                self._preempt(max(victims)[1])
            self._pt[b] = self.alloc.page_row(
                req.rid, self.spec.pages_per_request)

    def _preempt(self, slot: int):
        req = self._slots[slot]
        self.alloc.free(req.rid)
        req.tokens = []
        req.first_token_t = None
        req.preemptions += 1
        req.admit_seq = -1
        self._clear_slot(slot)
        self._queue.appendleft(req)
        self.stats["preemptions"] += 1
        self.telemetry.event("preempt", rid=req.rid,
                             preemptions=req.preemptions)

    def _finish(self, slot: int, req: Request, completed: List[Request]):
        req.finish_t = time.perf_counter()
        self.alloc.free(req.rid)
        self._clear_slot(slot)
        self.stats["completed"] += 1
        # observed at finish so a preempted-and-restarted request
        # contributes exactly one TTFT sample — that of its successful run
        if req.first_token_t is not None:
            self._lat["ttft"].observe(req.first_token_t - req.submit_t)
        self._lat["e2e"].observe(req.finish_t - req.submit_t)
        completed.append(req)

    def latency_stats(self) -> dict:
        """TTFT and end-to-end p50/p99 (seconds) over every request finished
        since the last ``reset_latency_stats``, plus the sample count."""
        ttft, e2e = self._lat["ttft"], self._lat["e2e"]
        return {"n": e2e.count,
                "ttft_p50_s": ttft.percentile(50),
                "ttft_p99_s": ttft.percentile(99),
                "e2e_p50_s": e2e.percentile(50),
                "e2e_p99_s": e2e.percentile(99)}

    def reset_latency_stats(self):
        self._lat = {"ttft": Histogram(), "e2e": Histogram()}

    def _clear_slot(self, slot: int):
        self._slots[slot] = None
        self._pt[slot] = 0
        self._lengths[slot] = 0
        self._last_tok[slot] = 0
