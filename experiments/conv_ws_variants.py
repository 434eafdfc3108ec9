"""What bounds the conv's warp-specialised instance, on the card.

    python3 experiments/conv_ws_variants.py [--batch 256] [--reps 10] \
        [--only NAME ...]

Builds variants of ``src/repro_torch/kernels/csrc/conv2d.cu``, each with
substitutions in its warp-specialised pipeline, into
``src/repro_torch/kernels/_build/variants_conv/<name>/`` (one nvcc a
variant, all at once), and times each through its C entry
``conv2d_nhwc_ws_f32`` with CUDA events at VGG-A's convs 2-8 (``--batch``
images), with the tiled instance's C entry (``conv2d_nhwc_f32``) of the
shipped source beside them.  The variants:

- ``shipped``: the source as it is;
- ``no_wgmma``: the consumers wait for each stage and release it, and issue
  no product;
- ``no_gather``: the producer stores constants instead of x's rows (its
  splits, stores and barriers stay);
- ``no_a``: the producer neither loads nor stores A (barriers only);
- ``no_tma``: no B tiles are copied;
- ``no_turns``: the consumers issue their runs without taking turns;
- ``no_split``: the producer stores x's chunks as they are, once (no
  tf32 split, no lo part);
- ``stages_4``: four stages in the ring;
- ``divide_taps``: the producer finds each chunk's tap by dividing its
  depth (``Im2colRows``, the tiled instance's loader) instead of walking;

Three larger alternatives (two producer warpgroups, a cp.async ring of x
ahead of the split, 2-block clusters sharing B by TMA multicast) were timed
the same way and lost; ``PERF.md`` keeps their readings, not their code.

Every variant but the ``no_`` ones computes the conv and is checked bitwise
against the tiled instance, layer by layer, before its first timing.
Prints each variant's ms a layer and the sum, twice in turn.
Needs one sm_90 card; prints the card's name and power limit first.
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402

LOAD0 = "      rows.load(r0, ws::kBK);\n"
LOAD1 = "        rows.load(r1, ws::kBK);\n"
LOAD2 = "        if (j + 2 < n_stages) rows.load(r0, ws::kBK);\n"
CONST = ("      for (int i = 0; i < ws::kLoads; ++i) r0[i] = r1[i] = "
         "make_uint4(1, 2, 3, j0);\n")
PUT = ("        tc_gemm::put<true>(a, Cf::A_PART, tc_gemm::swz<ws::kRow>(row + "
       "ws::kRowStep * i, col),\n                           r[i]);\n")
TAPS = ("      TapRows<ws::kLoads> rows(x, H, W, C, K, stride, pad, OH, OW, M, "
        "tile_m0(u) + row,\n                               ws::kRowStep, col * 4);\n")
VARIANTS = {
    "shipped": [],
    "no_wgmma": [
        ("    float part[Cf::ACC];", "    float part[Cf::ACC] = {};"),
        ("        wgmma_ss_kmajor<BN, true, lo_a + kk, kk>(part, da, db, add);\n"
         "        wgmma_ss_kmajor<BN, true, kk, lo_b + kk>(part, da, db, 1);\n"
         "        wgmma_ss_kmajor<BN, true, kk, kk>(part, da, db, 1);\n", "")],
    "no_gather": [(LOAD0, "      const int j0 = static_cast<int>(u);\n" + CONST),
                  (LOAD1, ""), (LOAD2, "")],
    "no_a": [(LOAD0, "      const int j0 = 0;\n" + CONST), (LOAD1, ""),
             (LOAD2, ""), (PUT, "        (void)r;\n")],
    "no_tma": [("        mbar_arrive_expect_tx(full(slot), 2 * Cf::B_PART);\n",
                "        mbar_arrive(full(slot));\n"),
               ("        tma_load_4d(st + 2 * Cf::A_PART, &wmap, full(slot), j * ws::kBK, "
                "n0, 0, 0);\n        tma_load_4d(st + 2 * Cf::A_PART + Cf::B_PART, &wmap, "
                "full(slot), j * ws::kBK, n0, 1, 0);\n", "")],
    "no_turns": [("        ws::turn_wait(ws::kTurn + c);\n", ""),
                 ("        ws::turn_pass(ws::kTurn + 1 - c);", "        //"),
                 ("    if (c == 1) ws::turn_pass(ws::kTurn);", "    //"),
                 ("    if (c == 0) ws::turn_wait(ws::kTurn);", "    //")],
    "no_split": [("        tc_gemm::put<true>(", "        tc_gemm::put<false>(")],
    "stages_4": [("constexpr int kStages = 6;", "constexpr int kStages = 4;")],
    "divide_taps": [
        (TAPS, "      const Im2colRows<ws::kLoads> rows(x, H, W, C, K, stride, pad, OH, "
               "OW, M, true, tile_m0(u) + row, ws::kRowStep);\n      int kq = col * 4;\n"),
        (LOAD0, "      rows.load(kq, r0);\n      kq += ws::kBK;\n"),
        (LOAD1, "        rows.load(kq, r1);\n        kq += ws::kBK;\n"),
        (LOAD2, "        if (j + 2 < n_stages) rows.load(kq, r0);\n"
                "        kq += ws::kBK;\n")],
}


def build_variant(name):
    """(name, ctypes.CDLL) of the variant; raises with nvcc's output, or if
    ptxas spilled or serialized the wgmmas."""
    out = os.path.join(build.BUILD_DIR, "variants_conv", name)
    os.makedirs(out, exist_ok=True)
    for f in ("conv2d.cu", "gemm_tf32x3.cuh", "hopper.cuh"):
        shutil.copy(build.CSRC / f, out)
    path = os.path.join(out, "conv2d.cu")
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in the source")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(out, "conv2d.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, path],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{log}")
    lines = cs.build_lines(log)
    bad = [x for x in lines if "ptxas" in x and "warning" in x
           or "Performance Loss" in x
           or "spill" in x and " 0 bytes spill stores" not in x]
    if bad:
        raise RuntimeError(f"{name}: {bad}")
    print(f"{name}: {[x for x in lines if 'warp-specialised 128 x 128' in x]}",
          flush=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv2d_nhwc_ws_f32.argtypes = [p] * 4 + [i] * 10 + [p]
    lib.conv2d_nhwc_f32.argtypes = [p] * 3 + [i] * 10 + [p]
    return name, lib


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS),
                    help="build and time these variants alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    print(card)
    names = args.only or list(VARIANTS)
    if "shipped" not in names:   # the tiled instance comes from its build
        names = ["shipped", *names]
    def built(name):   # a variant that fails to build is reported and left out
        try:
            return build_variant(name)
        except RuntimeError as e:
            print(f"{name}: not built: {e}", flush=True)
            return name, None
    with ThreadPoolExecutor(len(names)) as pool:
        libs = {n: lib for n, lib in pool.map(built, names) if lib is not None}
    N = args.batch
    layers = cs.conv_layer_shapes(get_config("vgg-a"))[1:]
    data = []
    for j, (name, H, C, F, K, s, p) in enumerate(layers):
        gen = torch.Generator(device=dev).manual_seed(200 + j)
        x = torch.randn(N, H, H, C, generator=gen, device=dev)
        w = torch.randn(K, K, C, F, generator=gen, device=dev) \
            / (K * K * C) ** 0.5
        OH, OW = kconv.out_hw(H, H, K, s, p)
        data.append((name, x, w, torch.empty(2 * F * K * K * C, device=dev),
                     torch.empty(N, OH, OW, F, device=dev),
                     (N, H, H, C, K, F, s, p, OH, OW)))

    def call(lib, d, tiled=False):
        _, x, w, ws, out, shape = d
        if tiled:
            kconv.launch(lib.conv2d_nhwc_f32, dev, x.data_ptr(), w.data_ptr(),
                         out.data_ptr(), *shape)
        else:
            kconv.launch(lib.conv2d_nhwc_ws_f32, dev, x.data_ptr(),
                         w.data_ptr(), ws.data_ptr(), out.data_ptr(), *shape)

    want = []
    for d in data:   # the tiled instance's outputs, kept on the host
        call(libs["shipped"], d, tiled=True)
        want.append(d[4].cpu())
    runs = [("tiled", libs["shipped"], True)] + [
        (n, lib, False) for n, lib in libs.items()]
    for rnd in range(2):
        for name, lib, tiled in (runs if rnd == 0 else runs[::-1]):
            same = ""
            if rnd == 0 and not tiled and not name.startswith("no_"):
                eq = []
                for d, wd in zip(data, want):
                    call(lib, d)
                    eq.append(torch.equal(d[4].cpu(), wd))
                same = f"; bitwise the tiled instance at each layer {eq}"
            per = [cs.cuda_ms(lambda: call(lib, d, tiled), 2, args.reps)
                   for d in data]
            print(f"round {rnd} {name}: {sum(per)} ms for convs 2-8 at batch "
                  f"{N}; by layer {[round(v, 4) for v in per]}{same} "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
