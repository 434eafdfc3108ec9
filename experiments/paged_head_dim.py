"""The paged-decode kernel before and after it took every head_dim
``D % 8 == 0`` (h2o-danube-3-4b's 120 among them).

    python3 experiments/paged_head_dim.py PARENT_PAGED_ATTN_CU

PARENT_PAGED_ATTN_CU is the kernel source before the change, for example
from ``git show c545b7d:src/repro_torch/kernels/csrc/paged_attn.cu``
written to a git-ignored directory (``_checkout/``).  Builds it and
``src/repro_torch/kernels/csrc/paged_attn.cu``
into ``src/repro_torch/kernels/_build/variants/`` (one nvcc each, at once)
and times both through their C entries in the order parent, change,
change, parent, at llama3-8b's serving shapes (B 4, Hq 32, Hkv 8, D 128,
pages of 16, ``chip_smoke.py`` phase 1's lengths and a live step's) and a
long context (4 x 4096 positions): each as a CUDA graph of its two
launches (the device's time alone) and one call at a time (host time
before the launch included), with max |error| against the plain version.
Then the change alone at h2o-danube's heads (Hq 32, Hkv 8, D 120; window
0 and 40), beside the byte bound.  Needs one sm_90 card; prints the card's
name and power limit first.
"""
from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, paged_attn  # noqa: E402
from topk_paged_variants import build_variant  # noqa: E402


def _call(lib, q, pk, pv, pt, ln, out, scratch, pps, window):
    B, Hq, D = q.shape
    P, ps, Hkv, _ = pk.shape
    rc = lib.paged_decode_attention(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), pt.data_ptr(),
        ln.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, P,
        ps, pt.shape[1], pps, window, 0.0, D ** -0.5, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = sys.argv[1]
    if not os.path.isfile(parent):
        raise FileNotFoundError(f"no parent kernel source at {parent}")
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    jobs = [("paged_head_dim_change", str(build.CSRC / "paged_attn.cu"), []),
            ("paged_head_dim_parent", parent, [])]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = {k: v[0] for k, v in pool.map(build_variant, jobs)}
    order = ["paged_head_dim_parent", "paged_head_dim_change",
             "paged_head_dim_change", "paged_head_dim_parent"]
    dev = torch.device("cuda")
    ps = 16
    cases = [("serving, phase 1's lengths", 34, [1, 16, 300, 544]),
             ("serving, a live step's lengths", 34, [446, 371, 475, 207]),
             ("long context", 256, [4096] * 4)]
    for title, n, lengths in cases:
        q, pk, pv, pt, ln = cs.paged_inputs(dev, 4, 32, 8, 128, ps, n,
                                            4 * n + 16, lengths, seed=n)
        out = torch.empty_like(q)
        want = paged_attn.paged_decode_attention_plain(q, pk, pv, pt, ln)
        pps = paged_attn.split_pages(4, 8, 4, n)
        scratch = torch.empty(4 * 32 * -(-n // pps) * 130, device=dev)
        bound, _ = cs.paged_bound(q, pk, pt, lengths, 0)
        res = []
        for i, key in enumerate(order):
            lib = built[key]
            _call(lib, q, pk, pv, pt, ln, out, scratch, pps, 0)
            err = (out.float() - want.float()).abs().max().item()
            graph = cs.graph_ms(lambda: _call(lib, q, pk, pv, pt, ln, out,
                                              scratch, pps, 0))
            one = cs.cuda_ms(lambda: _call(lib, q, pk, pv, pt, ln, out,
                                           scratch, pps, 0))
            res.append(f"{i + 1}. {key.rsplit('_', 1)[1]}: device {graph} "
                       f"ms, one call {one} ms, max|err| {err}")
        print(f"paged decode, {title} {lengths} (B 4, Hq 32, Hkv 8, D 128, "
              f"n {n}, {pps} pages a split): bound {bound} ms; "
              + "; ".join(res) + f" [{card}]", flush=True)
    lib = built["paged_head_dim_change"]
    lengths = [1, 16, 300, 544]
    q, pk, pv, pt, ln = cs.paged_inputs(dev, 4, 32, 8, 120, ps, 34, 160,
                                        lengths, seed=120)
    out = torch.empty_like(q)
    pps = paged_attn.split_pages(4, 8, 4, 34)
    scratch = torch.empty(4 * 32 * -(-34 // pps) * 122, device=dev)
    for window in (0, 40):
        want = paged_attn.paged_decode_attention_plain(q, pk, pv, pt, ln,
                                                       window=window)
        _call(lib, q, pk, pv, pt, ln, out, scratch, pps, window)
        err = (out.float() - want.float()).abs().max().item()
        graph = cs.graph_ms(lambda: _call(lib, q, pk, pv, pt, ln, out,
                                          scratch, pps, window))
        bound, _ = cs.paged_bound(q, pk, pt, lengths, window)
        print(f"paged decode at h2o-danube's heads (Hq 32, Hkv 8, D 120), "
              f"window {window}, lengths {lengths}: device {graph} ms, bound "
              f"{bound} ms, max|err| {err} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
