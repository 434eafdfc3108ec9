"""What bounds the 3xTF32 mainloop, and what its promotion costs, on the card.

    python3 experiments/tf32x3_variants.py

Builds variants of the blocked GEMM
(``src/repro_torch/kernels/csrc/blocked_matmul.cu`` on ``gemm_tf32x3.cuh``),
each with one substitution in the mainloop header, into
``src/repro_torch/kernels/_build/variants/<name>/`` (one nvcc a variant, all
at once), and times each through its C entry with CUDA events at the
shapes of its training path: CD-DNN's 8 forward products at batch 1024.
The direct conv is not among them: every conv layer but the first of
VGG-A and OverFeat-FAST runs the conv's own warp-specialised pipeline
(``csrc/conv2d.cu``), which this header does not carry;
``experiments/conv_ws_variants.py`` builds its variants.  The variants:

- ``shipped``: the header as it is (the promotion every 32 of the depth);
- ``promote_64``, ``promote_128``, ``no_promotion``: the partial sum promoted
  every 64 or 128 of the depth, or only at the end;
- ``no_wgmma``: the loads, splits and stores without the products;
- ``no_loads_stores``: the products without the loads, splits and stores;
- ``no_a_loads``, ``no_b_loads``, ``no_split``: one part of the load path
  left out.

The first four compute the product; each prints the largest
|kernel - plain| over max |plain| of any layer, and the signed relative bias
against an f64 product, sum((kernel - f64) sign(f64)) / sum|f64| (negative:
the outputs shrink).  The others compute nothing meaningful and are timed
only.  Needs one sm_90 card; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.blocking import solve_h100_gemm_blocking  # noqa: E402
from repro_torch.kernels import blocked_matmul as kmm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

PROMOTE = "constexpr int kPromoteDepth = 32;"
VARIANTS = {
    "shipped": [],
    "promote_64": [(PROMOTE, "constexpr int kPromoteDepth = 64;")],
    "promote_128": [(PROMOTE, "constexpr int kPromoteDepth = 128;")],
    "no_promotion": [(PROMOTE, "constexpr int kPromoteDepth = 1 << 20;")],
    "no_wgmma": [("    issue(slot, fresh);\n", "")],
    "no_loads_stores": [("    if (t + 1 < n_stages) store(slot);\n", ""),
                        ("    if (t + 2 < n_stages) load(t + 2);\n", "")],
    "no_a_loads": [("    rows.load(k0 + a_col * C::E, ra);",
                    "    for (int i = 0; i < C::A_LOADS; ++i) "
                    "ra[i] = make_uint4(i, k0, 2, 3);")],
    "no_b_loads": [("      rb[i] = load_b_chunk(b, k0 + (b_col + C::B_COL_STEP"
                    " * i) * C::E, K, N, n0 + b_n);",
                    "      rb[i] = make_uint4(i, 1, 2, 3);")],
    "no_split": [("      hi[j] = hopper::tf32_rna(x[j]);", "      hi[j] = x[j];"),
                 ("      lo[j] = hopper::tf32_rna(x[j] - hi[j]);",
                  "      lo[j] = x[j];")],
}
COMPUTES = ("shipped", "promote_64", "promote_128", "no_promotion")
SOURCES = ("blocked_matmul",)


def build_variant(name):
    """The variant's library, {source: ctypes.CDLL}; raises with nvcc's
    output, or if ptxas spilled or warned."""
    out = os.path.join(build.BUILD_DIR, "variants", name)
    os.makedirs(out, exist_ok=True)
    for f in ("blocked_matmul.cu", "gemm_tf32x3.cuh", "hopper.cuh"):
        shutil.copy(build.CSRC / f, out)
    path = os.path.join(out, "gemm_tf32x3.cuh")
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in the header")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    libs = {}
    for src in SOURCES:
        so = os.path.join(out, f"{src}.so")
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so,
             os.path.join(out, f"{src}.cu")], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{name}/{src}: nvcc failed:\n{log}")
        bad = [x for x in cs.build_lines(log) if "warning" in x or (
            "spill" in x and " 0 bytes spill stores" not in x)]
        if bad:
            raise RuntimeError(f"{name}/{src}: {bad}")
        libs[src] = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["blocked_matmul"].blocked_matmul.argtypes = [p, p, p] + [i] * 6 + [p]
    return name, libs


def bias(got, want):
    """Signed relative bias of got against the f64 product want."""
    return ((got.double() - want) * want.sign()).sum().item() \
        / want.abs().sum().item()


def run(libs, computes, dev):
    """(GEMM ms, worst |kernel - plain| / max|plain|, GEMM bias) of one
    variant; the last two None where it computes nothing."""
    stream = torch.cuda.current_stream().cuda_stream
    gemm = libs["blocked_matmul"].blocked_matmul
    layers = cs.dnn_layer_shapes(get_config("cd-dnn"), cs.DNN_BATCH)
    t_gemm = worst = 0.0
    g_bias = []
    for M, N, K in sorted(set(layers)):
        gen = torch.Generator(device=dev).manual_seed(K + N)
        a = torch.randn(M, K, generator=gen, device=dev)
        b = torch.randn(K, N, generator=gen, device=dev)
        c = torch.empty(M, N, device=dev)
        blk = solve_h100_gemm_blocking(M, N, K)

        def call():
            rc = gemm(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                      blk.bm, blk.bn, 0, stream)
            assert rc == 0, rc
        call()
        torch.cuda.synchronize()
        if computes:
            want = kmm.blocked_matmul_plain(a, b)
            worst = max(worst, ((c - want).abs().max()
                                / want.abs().max()).item())
            g_bias.append(bias(c, a.double() @ b.double()))
        t_gemm += cs.cuda_ms(call, 3, 20) * layers.count((M, N, K))
    if not computes:
        return t_gemm, None, None
    return t_gemm, worst, sum(g_bias) / len(g_bias)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc a variant
        built = dict(pool.map(build_variant, VARIANTS))
    for rnd in range(2):   # every variant twice, in turn
        for name, libs in built.items():
            g, worst, gb = run(libs, name in COMPUTES, dev)
            extra = ("" if worst is None else
                     f"; worst |kernel - plain| / max|plain| {worst}; bias "
                     f"against f64 {gb}")
            print(f"round {rnd} {name}: CD-DNN's 8 products {g} ms{extra} "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
