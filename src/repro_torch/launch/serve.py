"""Serving launcher of the port: continuous batching over the paged KV
cache, through ``ServeSpec -> compile_serve``.

``python -m repro_torch.launch.serve --arch llama3-8b --smoke --requests 8``

Runs on the GPU through the paged-decode kernel; ``--device cpu`` runs on
the CPU (there the kernel's plain version computes the attention), and
``--attn-impl gather`` picks the plain version on the GPU too.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import ServeSpec, compile_serve
from repro_torch.api.spec import PAGED_ATTN_IMPLS, SCHEDULER_POLICIES
from repro_torch.configs import ARCHS, ModelConfig, get_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    choices=[a for a in ARCHS
                             if isinstance(get_config(a), ModelConfig)])
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--scheduler", default="continuous",
                    choices=list(SCHEDULER_POLICIES))
    ap.add_argument("--attn-impl", default="kernel",
                    choices=list(PAGED_ATTN_IMPLS))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    spec = ServeSpec(arch=args.arch, smoke=args.smoke,
                     max_batch=args.max_batch, page_size=args.page_size,
                     num_pages=args.num_pages, max_prompt=args.prompt_len,
                     max_new_tokens=args.new, scheduler=args.scheduler,
                     attn_impl=args.attn_impl, temperature=args.temperature,
                     seed=args.seed)
    server = compile_serve(spec, device=args.device)

    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(2, args.prompt_len + 1, size=args.requests)
    for L in lengths:
        server.submit(rng.integers(1, server.cfg.vocab_size, size=int(L)))

    t0 = time.perf_counter()
    done = server.drain()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in done)
    print(f"served {len(done)} requests / {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s incl. kernel build) on {server.device} "
          f"scheduler={spec.scheduler} preemptions="
          f"{server.stats['preemptions']}")
    print("first request:", done[0].output[:16].tolist())
    return done


if __name__ == "__main__":
    main()
