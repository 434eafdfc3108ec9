"""The direct conv's two instances, layer by layer, on the card.

    python3 experiments/conv_ws_layers.py [--batches 64 256] [--reps 20]

Times VGG-A's 8 forward convs at each batch, in turns, through the wrapper
(``kernels.conv2d.conv2d_nhwc``: the warp-specialised instance for convs
2-8, its weight split included) and through the tiled instance's C entry
(``conv2d_nhwc_f32``, the one every conv took before the warp-specialised
instance), with CUDA-event medians of ``--reps`` calls after 3 warm-up
calls; prints each layer's times beside its 3xTF32 bound (``chip_smoke``'s
``conv_bound``), the sums, and whether the two instances agree to the bit.
Needs one sm_90 card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import conv2d as kconv  # noqa: E402


def times_ms(fn, reps):
    """CUDA-event ms of each of ``reps`` calls of fn after 3 warm-up."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    print(card)
    lib = kconv._lib()
    for N in args.batches:
        tot = {"ws": 0.0, "tiled": 0.0, "bound": 0.0}
        for j, (name, H, C, F, K, s, p) in enumerate(
                cs.conv_layer_shapes(get_config("vgg-a"))):
            gen = torch.Generator(device=dev).manual_seed(100 + j)
            x = torch.randn(N, H, H, C, generator=gen, device=dev)
            w = torch.randn(K, K, C, F, generator=gen, device=dev) \
                / (K * K * C) ** 0.5
            OH, OW = kconv.out_hw(H, H, K, s, p)
            tiled_out = torch.empty(N, OH, OW, F, device=dev)

            def tiled():
                kconv.launch(lib.conv2d_nhwc_f32, dev, x.data_ptr(),
                             w.data_ptr(), tiled_out.data_ptr(), N, H, H, C,
                             K, F, s, p, OH, OW)

            def wrapper():
                return kconv.conv2d_nhwc(x, w, stride=s, padding=p)
            tiled()
            same = torch.equal(wrapper(), tiled_out)
            t = {"ws": [], "tiled": []}
            for rnd in range(2):   # in turns: tiled, wrapper, wrapper, tiled
                order = ("tiled", "ws") if rnd == 0 else ("ws", "tiled")
                for k in order:
                    t[k] += times_ms(tiled if k == "tiled" else wrapper,
                                     args.reps)
            med = {k: statistics.median(v) for k, v in t.items()}
            bound = cs.conv_bound(N, H, C, F, K, s, p)[0]
            for k in med:
                tot[k] += med[k]
            tot["bound"] += bound
            print(f"batch {N} {name} ({H}x{H}x{C} -> {F}, "
                  f"{kconv.path(C, F, K, s)} instance): wrapper "
                  f"{med['ws']} ms, tiled {med['tiled']} ms, 3xTF32 bound "
                  f"{bound} ms (wrapper / bound {med['ws'] / bound}, tiled / "
                  f"bound {med['tiled'] / bound}); bitwise equal {same} "
                  f"[{card}]", flush=True)
            del x, w, tiled_out
        print(f"batch {N} VGG-A's 8 convs: wrapper {tot['ws']} ms, tiled "
              f"{tot['tiled']} ms, bound {tot['bound']} ms (wrapper / bound "
              f"{tot['ws'] / tot['bound']}, tiled / bound "
              f"{tot['tiled'] / tot['bound']}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
