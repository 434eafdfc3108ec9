"""Continuous-batching serving example (``examples/serve_batched.py``),
through the ``ServeSpec`` seam.

A mixed-length prompt batch is submitted to a ``repro_torch.api.Server``;
the scheduler packs requests into paged-KV decode slots in flight, so a
short request finishing frees its slot (and pages) for the next queued
prompt at once, with no wait for the longest request of a wave
(``--scheduler static`` waits).  On the card the paged decode runs on its
kernel (``ServeSpec.attn_impl="kernel"``).

    PYTHONPATH=src python -m repro_torch.launch.serve_batched --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.launch.serve_batched --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import ServeSpec, compile_serve


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def serve_spec(args) -> ServeSpec:
    return ServeSpec(arch=args.arch, smoke=True, max_batch=args.max_batch,
                     page_size=16, num_pages=128,
                     max_prompt=args.prompt_len,
                     max_new_tokens=args.new_tokens,
                     scheduler=args.scheduler)


def submit_requests(server, args) -> list:
    """The example's heavy-tail-ish mix (mostly short prompts and outputs,
    a few long ones), drawn from ``default_rng(0)``; returns the
    (prompt, max_new) pairs submitted."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        L = int(rng.integers(4, args.prompt_len + 1))
        new = args.new_tokens if i % 4 == 0 else max(args.new_tokens // 6, 1)
        prompt = rng.integers(1, server.cfg.vocab_size, size=L)
        server.submit(prompt, new)
        reqs.append((prompt, new))
    return reqs


def main(argv=None):
    """Serve the mix; returns (server, completed requests)."""
    args = parse_args(argv)
    spec = serve_spec(args)
    server = compile_serve(spec, device=args.device)
    submit_requests(server, args)

    t0 = time.perf_counter()
    done = server.drain()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in done)
    lat = sorted(r.latency for r in done)
    print(f"{spec.scheduler}: {len(done)} requests, {n_tok} tokens in "
          f"{dt:.2f}s ({n_tok / dt:.0f} tok/s)")
    print(f"latency p50={lat[len(lat) // 2] * 1e3:.0f} ms "
          f"max={lat[-1] * 1e3:.0f} ms  "
          f"scheduler steps={server.stats['steps']}  "
          f"preemptions={server.stats['preemptions']}")
    print("sample:", done[0].output[:16].tolist())
    return server, done


if __name__ == "__main__":
    main()
