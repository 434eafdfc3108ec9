#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

It drives ``repro_torch`` only (never JAX or the JAX package), on the card,
and fails (non-zero exit, no result line) when any phase fails:

Phase 0  build every kernel of the ported paths from ``src/repro_torch``
         (one nvcc per source, all at once); print the build times, what
         ``-Xptxas -v`` reports, and the card's name and power limit.
Phase 1  the paged-decode kernel against its plain PyTorch version, on the
         card, at the serving path's shapes and a few variants; max |error|
         against a stated tolerance; CUDA-event times of both beside the
         kernel's least possible time (its bound).
Phase 2  the serving path: llama3-8b at full width and depth with random
         f32 weights from a seed, through ``compile_serve``; 8 requests of
         2-512 prompt tokens and 32 new tokens each, drained.  Launch counts
         are zeroed just before the drain and read just after: every kernel
         of the path must have launched (paged decode: exactly decode steps
         x 32 layers, conv: never).  Then one decode step with the plain
         attention and one with the kernel on the same live state must agree.
Phase 3  the direct-conv kernel against its plain version, f32 with TF32
         off, at every conv layer of VGG-A and OverFeat-FAST at batch 64;
         CUDA-event times of the kernel, the plain version, ``F.conv2d``
         (the library call) and the reference backward, beside the bound.
Phase 4  the training path: full-width VGG-A through ``compile_run`` and
         ``Run.fit`` for 6 steps of batch 64 with every forward conv on the
         kernel.  Launch counts are zeroed just before ``fit`` and read just
         after (conv: exactly 8 x 6, paged decode: never).  Then one forward
         and backward through the kernel and one through the plain route,
         from the same params and batch, must agree.

The line before the last is a JSON object of per-kernel findings, the last
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
REL_L2_TOL = 0.025             # kernel vs gather decode logits, phase 2
# phase 3: max |kernel - plain| over max |plain| of a conv layer.  Each
# output is an f32 sum of up to K*K*IFM = 9216 products, which the kernel
# and cuBLAS take in different orders; with unit-scale inputs their
# rounding differs by a few 1e-6 of the output's scale.
CONV_REL_TOL = 2e-5
# phase 4: kernel route vs plain route from the same params and batch.  The
# forward convs differ by rounding (above) in each of 8 layers, carried
# through 3 FC layers: the loss to a relative 1e-5.  The backward is the
# same cuDNN call on both routes, run deterministically for the check, but
# at full width with random weights the gradients below the last two FC
# layers are small sums of large per-sample terms of both signs, so any
# f32-level change of the forward moves them by ~1e-3 in relative L2.  The
# run measures that sensitivity per leaf (the plain route with every conv
# weight scaled by 1 + 2^-23) and holds each leaf of the kernel route to
# SENSITIVITY_FACTOR times it, and never tighter than GRAD_REL_L2_TOL; a
# backward wired wrongly differs by O(1).
LOSS_REL_TOL = 1e-5
GRAD_REL_L2_TOL = 1e-4
SENSITIVITY_FACTOR = 10.0


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
    """A recorder for ``Server`` and ``Trainer``: host-clock span times that
    end in a device synchronise, summed per kind, and counts."""
    sync = True

    def __init__(self):
        self.seconds = {}
        self.samples = {}
        self.counts = {}

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

    def count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n

    def reset(self):
        self.seconds.clear()
        self.samples.clear()
        self.counts.clear()


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
    from repro_torch.kernels import conv2d as kconv
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
    kconv.launches = 0
    t0 = time.perf_counter()
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attn.launches
    check(kconv.launches == 0, f"serving launched the conv kernel "
          f"{kconv.launches} times")
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


# ---------------------------------------------------------------------------
# phase 3: direct conv, kernel vs plain, every layer of the paper's CNNs
# ---------------------------------------------------------------------------
def conv_layer_shapes(cfg):
    """(name, H_in, IFM, OFM, K, stride, pad) of every conv layer of
    ``cfg``, walking the spatial size through its convs and 2x2 pools."""
    h, out = cfg.image_size, []
    for i, lyr in enumerate(cfg.layers):
        if lyr.kind == "conv":
            out.append((f"{cfg.name} layer {i}", h, lyr.ifm, lyr.ofm,
                        lyr.kernel, lyr.stride, lyr.pad))
            h = (h + 2 * lyr.pad - lyr.kernel) // lyr.stride + 1
            check(h == lyr.out_hw, f"{cfg.name} layer {i}: {h} != "
                  f"{lyr.out_hw}")
        elif lyr.kind == "pool":
            h //= 2
    return out


def conv_bound(N, H, C, F, K, s, p):
    """Least time of one call on an H100 SXM: x, w and out moved once at
    3.35 TB/s, or 2 N OH OW F K K C operations at the f32 peak of 67
    TFLOP/s, whichever is longer.  Returns (ms, t_bytes, t_ops)."""
    OH = (H + 2 * p - K) // s + 1
    nbytes = 4 * (N * H * H * C + K * K * C * F + N * OH * OH * F)
    ops = 2 * N * OH * OH * F * K * K * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3


def phase3(dev, card):
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import conv2d as kconv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    N = 64
    print(f"phase 3: conv2d_nhwc kernel vs plain, f32, allow_tf32=False for "
          f"matmul and cuDNN, batch {N}; tolerance max|kernel - plain| <= "
          f"{CONV_REL_TOL} x max|plain| per layer; CUDA-event medians of 20 "
          f"calls after 3 warm-up [{card}]")
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "t_bytes": 0.0, "t_ops": 0.0, "bwd_ms": 0.0}
    worst = 0.0
    for arch in ("vgg-a", "overfeat-fast"):
        for j, (name, H, C, Fo, K, s, p) in enumerate(
                conv_layer_shapes(get_config(arch))):
            gen = torch.Generator(device=dev).manual_seed(100 + j)
            x = torch.randn(N, H, H, C, generator=gen, device=dev)
            w = torch.randn(K, K, C, Fo, generator=gen, device=dev) \
                / np.sqrt(K * K * C)
            got = kconv.conv2d_nhwc(x, w, stride=s, padding=p)
            torch.cuda.synchronize()
            want = kconv.conv2d_nhwc_plain(x, w, stride=s, padding=p)
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            check(err <= CONV_REL_TOL * scale,
                  f"{name}: kernel disagrees with the plain version "
                  f"({err} > {CONV_REL_TOL} x {scale})")
            worst = max(worst, err)
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            g = torch.randn_like(got)
            del got, want
            t = {
                "ms": cuda_ms(lambda: kconv.conv2d_nhwc(
                    x, w, stride=s, padding=p), 3, 20),
                "plain_ms": cuda_ms(lambda: kconv.conv2d_nhwc_plain(
                    x, w, stride=s, padding=p), 3, 20),
                "library_ms": cuda_ms(lambda: F.conv2d(
                    xn, wn, stride=s, padding=p), 3, 20),
                "bwd_ms": cuda_ms(lambda: kconv.conv2d_ref_backward(
                    x, w, g, s, p), 3, 20),
            }
            bound_ms, t_bytes, t_ops = conv_bound(N, H, C, Fo, K, s, p)
            print(f"  {name}: {H}x{H}x{C} -> {Fo}, {K}x{K} s{s} p{p}: "
                  f"max|kernel - plain| {err} (max|plain| {scale}); kernel "
                  f"{t['ms']} ms, plain {t['plain_ms']} ms, F.conv2d "
                  f"{t['library_ms']} ms, reference backward (input + "
                  f"weight grads) {t['bwd_ms']} ms; bound {bound_ms} ms ("
                  f"{'bytes' if t_bytes >= t_ops else 'operations'}; "
                  f"bytes {t_bytes} ms, operations {t_ops} ms) [{card}]")
            if arch == "vgg-a":     # the training path's shapes
                for k in t:
                    totals[k] += t[k]
                totals["bound_ms"] += bound_ms
                totals["t_bytes"] += t_bytes
                totals["t_ops"] += t_ops
            del x, w, xn, wn, g
    print(f"  VGG-A's 8 conv layers at batch {N}, one forward pass: kernel "
          f"{totals['ms']} ms, plain {totals['plain_ms']} ms, F.conv2d "
          f"{totals['library_ms']} ms, bound {totals['bound_ms']} ms; "
          f"reference backward {totals['bwd_ms']} ms [{card}]")
    return {"name": "conv2d_nhwc", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/conv2d.cu",
            "replaces": "src/repro/kernels/conv2d.py:85",
            "max_abs_err": worst, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
            "bound_by": ("operations" if totals["t_ops"] >= totals["t_bytes"]
                         else "bytes"),
            "library_ms": totals["library_ms"]}


# ---------------------------------------------------------------------------
# phase 4: train full-width VGG-A through compile_run -> Run.fit
# ---------------------------------------------------------------------------
def phase4(card):
    import torch.nn.functional as F

    from repro_torch.api import RunSpec, compile_run
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import paged_attn
    from repro_torch.kernels.ref import conv2d_ref
    from repro_torch.launch.paper_cnn_training import use_kernel
    from repro_torch.models import cnn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = RunSpec(arch="vgg-a", smoke=False, batch=64, steps=6, lr=5e-3,
                   schedule="constant", seed=0, log_every=1)
    spans = SyncedSpans()
    t0 = time.perf_counter()
    run = use_kernel(compile_run(spec, recorder=spans))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in run.params.values())
    n_conv = len(run.cfg.conv_layers())
    print(f"phase 4: {run.cfg.name}, {n_conv} conv layers, {n_params} f32 "
          f"params initialised on {run.device} in "
          f"{time.perf_counter() - t0:.2f} s; {spec.steps} steps of batch "
          f"{spec.batch}, every forward conv on the kernel")

    torch.cuda.reset_peak_memory_stats()
    kconv.launches = 0
    paged_attn.launches = 0
    t0 = time.perf_counter()
    hist = run.fit(log_fn=lambda line: print(f"  {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, paged = kconv.launches, paged_attn.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(hist) == spec.steps, f"{len(hist)} of {spec.steps} steps "
          "logged")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in hist), f"non-finite loss or grad norm: {hist}")
    check(launches == n_conv * spec.steps,
          f"conv kernel launched {launches} times in {spec.steps} steps x "
          f"{n_conv} conv layers")
    check(paged == 0, f"training launched the paged-decode kernel {paged} "
          "times")
    steps = spans.samples["step"]
    waits = spans.samples["data_wait"]
    later = sum(steps[1:]) + sum(waits[1:])
    n_later = spec.batch * (spec.steps - 1)
    print(f"  {spec.steps} steps in {wall} s; conv kernel launches "
          f"{launches} = {spec.steps} x {n_conv}; paged-decode launches "
          f"{paged}")
    print(f"  steps 2-{spec.steps}: {n_later / later} images/s with the "
          f"data waits ({n_later / sum(steps[1:])} images/s of step time "
          f"alone); step median {np.median(steps[1:]) * 1e3} ms; first step "
          f"{steps[0] * 1e3} ms; data_wait summed {sum(waits)} s over "
          f"{len(waits)} steps ({[w * 1e3 for w in waits]} ms); peak "
          f"memory {peak_gb} GB [{card}]")

    # the kernel route against the plain route, same params and batch.
    # cuDNN's default backward algorithms are not deterministic, so two runs
    # of one route differ (printed as the backward's noise); the check runs
    # with deterministic cuDNN, where they do not.  The network's own
    # sensitivity is printed beside it: the plain route again with every
    # conv weight scaled by 1 + 2^-23 (one or two ulps larger).
    batch = next(run.data)
    keys = sorted(run.params)

    def loss_and_grads(params, uk):
        loss = cnn.loss_fn(params, run.cfg, batch, use_kernel=uk)
        return loss.item(), torch.autograd.grad(
            loss, [params[k] for k in keys])

    def rel_l2(ga, gb):
        return {k: ((a - b).norm() / b.norm()).item()
                for k, a, b in zip(keys, ga, gb)}

    def worst(rel):
        k = max(rel, key=rel.get)
        return f"{rel[k]} at {k}"

    ps = run.params
    noise = rel_l2(loss_and_grads(ps, False)[1], loss_and_grads(ps, False)[1])
    torch.backends.cudnn.deterministic = True
    lk, gk = loss_and_grads(ps, True)
    lp, gp = loss_and_grads(ps, False)
    same = all(torch.equal(a, b)
               for a, b in zip(gp, loss_and_grads(ps, False)[1]))
    ulp = {k: (p.detach() * (1 + 2.0 ** -23) if k.startswith("conv")
               and k.endswith("_w") else p.detach()).requires_grad_()
           for k, p in ps.items()}
    floor = rel_l2(loss_and_grads(ulp, False)[1], gp)
    torch.backends.cudnn.deterministic = False
    check(np.isfinite(lk) and np.isfinite(lp), "non-finite parity loss")
    check(same, "deterministic cuDNN: two plain-route backwards differ")
    loss_rel = abs(lk - lp) / abs(lp)
    rel = rel_l2(gk, gp)
    print(f"  worst leaf's gradient relative L2: plain route twice, default "
          f"cuDNN (the backward's noise): {worst(noise)}; plain "
          f"route with each conv weight scaled by 1 + 2^-23 vs plain, "
          f"deterministic (the network's sensitivity): {worst(floor)}")
    tol = {k: max(GRAD_REL_L2_TOL, SENSITIVITY_FACTOR * floor[k])
           for k in keys}
    ratio = {k: rel[k] / tol[k] for k in keys}
    print(f"  kernel vs plain route, one forward and backward on the same "
          f"params and batch, deterministic cuDNN: loss {lk} vs {lp} "
          f"(relative {loss_rel}, tolerance {LOSS_REL_TOL}); gradients "
          f"{worst(rel)}; per leaf the tolerance is max({GRAD_REL_L2_TOL}, "
          f"{SENSITIVITY_FACTOR} x sensitivity), worst relative L2 / "
          f"tolerance {worst(ratio)}")
    print(f"  per leaf, kernel vs plain: {rel}")
    print(f"  per leaf, conv weights x (1 + 2^-23) vs plain: {floor}")
    check(loss_rel <= LOSS_REL_TOL, "kernel and plain route losses differ")
    check(max(ratio.values()) <= 1.0,
          "kernel and plain route gradients differ")
    del gk, gp, ulp

    # a discrete cause of the gradient gap would show here: after conv1,
    # the 2x2 pool windows with a positive max whose gradient goes to a
    # different input on the two routes
    lyr = run.cfg.layers[0]
    picks = []
    with torch.no_grad():
        for conv in (lambda x, w: kconv.conv2d_nhwc(
                x, w, stride=lyr.stride, padding=lyr.pad),
                     lambda x, w: conv2d_ref(x, w, lyr.stride, lyr.pad)):
            h = torch.relu(conv(batch["images"], ps["conv00_w"])
                           + ps["conv00_b"])
            picks.append(F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2,
                                      return_indices=True))
    live = (picks[0][0] > 0) & (picks[1][0] > 0)
    flips = ((picks[0][1] != picks[1][1]) & live).sum().item()
    print(f"  pool after conv1: {flips} of {live.sum().item()} windows with "
          f"a positive max route their gradient to another input on the "
          f"kernel route than on the plain route")
    del picks, live
    leaves = [ps[k] for k in keys]

    # where one training step's time goes (CUDA events, 3 reps, median)
    split = {"step": [], "forward": [], "backward": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = run.loss_fn(run.params, batch)
        ev[1].record()
        torch.autograd.grad(loss, leaves)
        ev[2].record()
        run.step(batch, step_idx=spec.steps)
        ev[3].record()
        ev[3].synchronize()
        split["forward"].append(ev[0].elapsed_time(ev[1]))
        split["backward"].append(ev[1].elapsed_time(ev[2]))
        split["step"].append(ev[2].elapsed_time(ev[3]))
    fwd, bwd, step = (float(np.median(split[k]))
                      for k in ("forward", "backward", "step"))
    print(f"  one step by CUDA events: whole train_step {step} ms; its "
          f"forward alone {fwd} ms, backward alone {bwd} ms, so gradient "
          f"norm, clipping and the SGD update about {step - fwd - bwd} ms "
          f"[{card}]")
    run.close()
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
    names = ("paged_attn", "conv2d")

    def timed_build(name):
        t0 = time.perf_counter()
        build.load(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        secs = dict(zip(names, pool.map(timed_build, names)))
    print(f"phase 0: built {', '.join(f'{n} in {secs[n]:.2f} s' for n in names)}"
          f", all in {time.perf_counter() - t0:.2f} s")
    for name in names:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    paged = phase1(dev)
    paged["launches"] = phase2(card)
    # free the serving model before training
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conv = phase3(dev, card)
    conv["launches"] = phase4(card)
    print(json.dumps({"kernels": [paged, conv]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
