#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

It drives ``repro_torch`` only (never JAX or the JAX package), on the card,
and fails (non-zero exit, no result line) when any phase fails:

Phase 0  build the serving path's kernel from ``src/repro_torch`` (one
         nvcc); print the build time and the card's name and power limit.
Phase 1  each kernel against its plain PyTorch version, on the card, at the
         shapes the serving path gives it and a few variants; max |error|
         against a stated tolerance; CUDA-event times of both beside the
         kernel's least possible time (its bound).
Phase 2  the serving path: llama3-8b at full width and depth with random
         f32 weights from a seed, through ``compile_serve``; 8 requests of
         2-512 prompt tokens and 32 new tokens each, drained.  Launch counts
         are zeroed just before the drain and read just after: every kernel
         of the path must have launched (paged decode: exactly decode steps
         x 32 layers).  Then one decode step with the plain attention and
         one with the kernel on the same live state must agree.

The line before the last is a JSON object of per-kernel findings, the last
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
REL_L2_TOL = 0.025             # kernel vs gather decode logits, phase 2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup=10, reps=50) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


class SyncedSpans:
    """A recorder for ``Server``: host-clock span times that end in a device
    synchronise, summed per kind."""

    def __init__(self):
        self.seconds = {}
        self.samples = {}

    def span(self, kind, **attrs):
        rec = self

        class _Span:
            def __enter__(self):
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                torch.cuda.synchronize()
                dt = time.perf_counter() - self.t0
                rec.seconds[kind] = rec.seconds.get(kind, 0.0) + dt
                rec.samples.setdefault(kind, []).append(dt)
                return False

        return _Span()

    def event(self, kind, **attrs):
        pass

    def reset(self):
        self.seconds.clear()
        self.samples.clear()


# ---------------------------------------------------------------------------
# phase 1: paged decode attention, kernel vs plain
# ---------------------------------------------------------------------------
def paged_inputs(dev, B, Hq, Hkv, D, ps, n, P, lengths, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=gen, device=dev).bfloat16()
    pk = torch.randn(P, ps, Hkv, D, generator=gen, device=dev).bfloat16()
    pv = torch.randn(P, ps, Hkv, D, generator=gen, device=dev).bfloat16()
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * n] + 1)
    pt = pt.reshape(B, n).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pk, pv, pt, ln


def paged_bound(q, pk, pt, lengths, window):
    """Least time of one call on an H100 SXM: the K and V rows of every
    attended position, q, the attended pages' table entries and the lengths
    read once, the output written once; about 4 Hq D operations per
    attended position."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = pk.shape
    pages = positions = 0
    for L in lengths:
        lo = max(0, L - window) if window > 0 else 0  # first attended position
        positions += L - lo
        pages += sum(1 for i in range(pt.shape[1])
                     if i * ps < L and i * ps + ps - 1 >= lo)
    el = pk.element_size()
    nbytes = (2 * positions * Hkv * D * el + 2 * q.numel() * el
              + pages * 4 + B * 4)
    ops = 4 * Hq * D * positions
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase1(dev):
    from repro_torch.kernels import paged_attn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1: paged_decode_attention kernel vs plain, bf16, "
          "allow_tf32=False for matmul and cuDNN; tolerance per request: "
          "1 bf16 ulp at the largest magnitude of that request's output")
    ps, n, P = 16, 34, 160
    lengths = [1, ps, 300, n * ps]       # one token, a page boundary, full
    variants = [  # (name, Hq, Hkv, D, window, softcap)
        ("llama3-8b heads", 32, 8, 128, 0, 0.0),
        ("llama3-8b heads, window 40", 32, 8, 128, 40, 0.0),
        ("llama3-8b heads, softcap 50", 32, 8, 128, 0, 50.0),
        ("gemma2 heads, window 40, softcap 50", 8, 4, 256, 40, 50.0),
    ]
    worst = 0.0
    for i, (name, Hq, Hkv, D, window, softcap) in enumerate(variants):
        q, pk, pv, pt, ln = paged_inputs(dev, 4, Hq, Hkv, D, ps, n, P,
                                         lengths, seed=i)
        kw = dict(window=window, logit_softcap=softcap)
        got = paged_attn.paged_decode_attention(q, pk, pv, pt, ln, **kw)
        torch.cuda.synchronize()
        want = paged_attn.paged_decode_attention_plain(q, pk, pv, pt, ln,
                                                       **kw)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = (got.float() - want.float()).abs().flatten(1).amax(1)   # (B,)
        tol = torch.exp2(torch.floor(torch.log2(
            want.float().abs().flatten(1).amax(1))) - 7)
        ratio = (err / tol).max().item()
        print(f"  {name}: max|kernel - plain| per request {err.tolist()}, "
              f"tolerance {tol.tolist()}; worst error/tolerance {ratio}")
        check(ratio <= 1.0, f"{name}: kernel disagrees with the plain version")
        if Hq == 32:
            worst = max(worst, err.max().item())
        if i == 0:   # the serving path's own shapes and options
            ms = cuda_ms(lambda: paged_attn.paged_decode_attention(
                q, pk, pv, pt, ln, **kw))
            plain_ms = cuda_ms(lambda: paged_attn.paged_decode_attention_plain(
                q, pk, pv, pt, ln, **kw))
            bound_ms, bound_by = paged_bound(q, pk, pt, lengths, window)
    print(f"  time at B=4 Hq=32 Hkv=8 D=128 ps=16 n=34 lengths={lengths}: "
          f"kernel {ms} ms, plain {plain_ms} ms, bound {bound_ms} ms "
          f"({bound_by})")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": "src/repro/kernels/paged_attn.py:131",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------------------------------------
# phase 2: serve llama3-8b at full width and depth
# ---------------------------------------------------------------------------
def phase2(card):
    from repro_torch.api import ServeSpec, compile_serve
    from repro_torch.kernels import paged_attn
    spec = ServeSpec(arch="llama3-8b", smoke=False, max_batch=4,
                     page_size=16, num_pages=160, max_prompt=512,
                     max_new_tokens=32, attn_impl="kernel")
    spans = SyncedSpans()
    t0 = time.perf_counter()
    server = compile_serve(spec, recorder=spans)
    torch.cuda.synchronize()
    cfg = server.cfg
    n_params = sum(w.numel() for w in _leaves(server.params))
    print(f"phase 2: {cfg.name} {cfg.num_layers} layers d_model "
          f"{cfg.d_model}, {n_params} f32 params initialised on "
          f"{server.device} in {time.perf_counter() - t0:.2f} s")

    # warm-up request (library handles, allocator), outside the counted run
    server.submit(np.arange(1, 33), 2)
    server.drain()
    spans.reset()
    server.reset_latency_stats()

    rng = np.random.default_rng(0)
    lengths = rng.integers(2, server.spec.max_prompt + 1, size=8)
    for L in lengths:
        server.submit(rng.integers(1, cfg.vocab_size, size=int(L)))
    steps0 = server.stats["steps"]
    torch.cuda.reset_peak_memory_stats()
    paged_attn.launches = 0
    t0 = time.perf_counter()
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attn.launches
    steps = server.stats["steps"] - steps0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(done) == 8, f"{len(done)} of 8 requests completed")
    for r in done:
        check(len(r.tokens) == server.spec.max_new_tokens,
              f"request {r.rid} returned {len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid} returned a token outside the vocabulary")
    check(steps > 0 and launches == steps * cfg.num_layers,
          f"paged-decode kernel launched {launches} times in {steps} decode "
          f"steps x {cfg.num_layers} layers")
    pre_s, dec_s = spans.seconds["prefill"], spans.seconds["decode"]
    n_pre = int(lengths.sum())
    n_dec = sum(len(r.tokens) - 1 for r in done)
    print(f"  served 8 requests ({n_pre} prompt tokens, {n_dec} decoded) in "
          f"{wall} s; {steps} decode steps, {launches} kernel launches "
          f"= steps x {cfg.num_layers}")
    print(f"  prefill {n_pre / pre_s} tok/s over {pre_s} s; decode "
          f"{n_dec / dec_s} tok/s over {dec_s} s; decode step median "
          f"{np.median(spans.samples['decode']) * 1e3} ms; peak memory "
          f"{peak_gb} GB [{card}]")
    lat = server.latency_stats()
    check(lat["n"] == 8, f"latency samples {lat['n']}")
    print(f"  all 8 submitted at once: TTFT p50 {lat['ttft_p50_s']} s p99 "
          f"{lat['ttft_p99_s']} s; end to end p50 {lat['e2e_p50_s']} s p99 "
          f"{lat['e2e_p99_s']} s [{card}]")

    # what one step spends recasting the f32 weights to bf16
    def cast_all():
        for w in _leaves(server.params):
            w.to(torch.bfloat16)

    cast_ms = cuda_ms(cast_all, 2, 5)
    print(f"  casting every weight f32 -> bf16 once: {cast_ms} ms "
          f"(the decode step does this) [{card}]")

    # gather vs kernel on one live decode state
    for L in rng.integers(2, server.spec.max_prompt + 1, size=4):
        server.submit(rng.integers(1, cfg.vocab_size, size=int(L)))
    server.step()
    ref = server.decode_logits("gather").float()
    got = server.decode_logits("kernel").float()
    check(tuple(got.shape) == (4, cfg.vocab_size), f"logits {got.shape}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(ref).all()),
          "non-finite logits")
    delta = (got - ref).abs().max().item()
    rel = ((got - ref).norm() / ref.norm()).item()
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * delta
    same = (got.argmax(-1) == ref.argmax(-1)) | ~decided
    # tolerance: per call the kernel is within one bf16 ulp of the plain
    # version (phase 1), but 32 layers of random weights carry those ulps
    # into the logits: 0.0183, the same bits in every run on an H100 80GB
    # HBM3 (PERF.md); the gate sits just above it
    print(f"  one decode step, kernel vs gather on the same state: max|dlogit| "
          f"{delta}, relative L2 {rel} (tolerance {REL_L2_TOL}), greedy "
          f"tokens agree wherever the top-2 margin exceeds 2 max|dlogit|: "
          f"{bool(same.all())}")
    check(rel <= REL_L2_TOL, "kernel and gather decode logits disagree")
    check(bool(same.all()), "greedy token differs at a decided step")

    # where one decode step's time goes, on this live state
    step_ms = {impl: cuda_ms(lambda: server.decode_logits(impl), 2, 5)
               for impl in ("kernel", "gather")}
    kp, vp = server._pools[0]
    q = torch.randn(spec.max_batch, cfg.num_heads, cfg.head_dim,
                    device=server.device).bfloat16()
    pt = torch.tensor(server._pt, device=server.device)
    ln = torch.tensor(server._lengths + 1, device=server.device)
    attn_ms = cuda_ms(lambda: paged_attn.paged_decode_attention(
        q, kp[0], vp[0], pt, ln))
    layers_attn = cfg.num_layers * attn_ms
    print(f"  decode step at lengths {(server._lengths + 1).tolist()}: "
          f"{step_ms['kernel']} ms with the kernel ({step_ms['gather']} ms "
          f"with gather); of it, weight recast {cast_ms} ms, paged attention "
          f"{cfg.num_layers} x {attn_ms} = {layers_attn} ms, the rest "
          f"{step_ms['kernel'] - cast_ms - layers_attn} ms [{card}]")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.load("paged_attn")
    print(f"phase 0: built paged_attn in {time.perf_counter() - t0:.2f} s")
    for line in build.BUILD_LOG.get("paged_attn", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  paged_attn: {line.strip()}")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    paged = phase1(dev)
    paged["launches"] = phase2(card)
    print(json.dumps({"kernels": [paged]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
