"""What bounds the ring's fold kernel on the card.

    python3 experiments/ring_fold_variants.py

Builds variants of ``src/repro_torch/kernels/csrc/ring.cu``, each with one
substitution in the fold kernel, into
``src/repro_torch/kernels/_build/variants/ring_<name>/`` (one nvcc per
variant, all at once), and times each through its C entry with CUDA events
on the shapes of the training paths: the reduce-scatter of VGG-A's 14
fusion buckets at G = 4 (the zero1 path's stride-0 stacks, and G distinct
partials) and one process-path hop at the largest strip (n = 25,690,112).
The variants:

- ``shipped``: the source as it is (2 words of a row a thread a trip, the
  loads of 4 rows before their adds, one block a tile of 512 words);
- ``unroll_1``, ``unroll_4``: 1 or 4 words a thread a trip;
- ``batch_1``, ``batch_8``: the loads of 1 or 8 rows before their adds;
- ``grid_fill``: a grid of the SMs times the blocks that fit, each block
  walking several tiles;
- ``grid_1024``: 1024 blocks a launch over the strips (the hop kernel's
  grid before the fold);
- ``loads_only``: the loads and adds, no store;
- ``stores_only``: the stores of zeros, no load.

The first seven compute the result and are held bitwise to the plain
versions; the last two are timed only.  Each is timed as a CUDA graph of its
launches (the device's time, no host time between launches), beside a copy
of the same bytes (``Tensor.copy_``, N in and N out) and the library calls
``chip_smoke.py`` names: ``view(G, G, n).sum(0)`` and ``torch.add``.  The
shipped wrappers and the library calls are also timed one call at a time,
as ``chip_smoke.py`` times them, where each call's time includes the host's
time to launch it.  Needs one sm_90 card; prints the card's name and power
limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from chip_smoke import graph_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402

STORE = "    if (i + u * kThreads < nw) __stcs(o + i + u * kThreads, acc[u]);"
VARIANTS = {
    "shipped": [],
    "unroll_1": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 1;")],
    "unroll_4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "batch_1": [("constexpr int kBatch = 4;", "constexpr int kBatch = 1;")],
    "batch_8": [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "grid_fill": [("const long long blocks = tiles;   // one tile a block",
                   "int dev = 0, sms = 0, fit = 0;\n"
                   "  cudaGetDevice(&dev);\n"
                   "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount"
                   ", dev);\n"
                   "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, "
                   "fold_kernel<T, W>, kThreads, 0);\n"
                   "  const long long blocks = tiles < 1LL * sms * fit / P ? "
                   "tiles : 1LL * sms * fit / P;")],
    "grid_1024": [("const long long blocks = tiles;   // one tile a block",
                   "const long long blocks = tiles < 1024 / P ? tiles : "
                   "1024 / P;")],
    # a store no random input reaches keeps the loads and adds alive
    "loads_only": [(STORE, "    if (i + u * kThreads < nw && reinterpret_cast"
                           "<const unsigned&>(acc[u]) == 0x7fc00001u) "
                           "__stcs(o + i + u * kThreads, acc[u]);")],
    "stores_only": [("__ldcs(row0 + i + u * kThreads)", "W()"),
                    ("__ldcs(xs + i + u * kThreads)", "W()"),
                    ("__ldcs(xs + row + i + u * kThreads)", "one[u]")],
}
COMPUTES = ("shipped", "unroll_1", "unroll_4", "batch_1", "batch_8",
            "grid_fill", "grid_1024")


def build_variant(name):
    """(name, the variant's ctypes.CDLL); raises with nvcc's output."""
    out = os.path.join(build.BUILD_DIR, "variants", f"ring_{name}")
    os.makedirs(out, exist_ok=True)
    with open(build.CSRC / "ring.cu") as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in ring.cu")
        text = text.replace(old, new)
    src, so = os.path.join(out, "ring.cu"), os.path.join(out, "ring.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{log}")
    lib = ctypes.CDLL(so)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ring_fold.argtypes = [i, p, p, ll, ll, p, p, i, i, i, i, ll, p]
    lib.ring_fold.restype = ctypes.c_int
    regs = [x for x in cs.build_lines(log) if "registers" in x]
    return name, (lib, regs)


def fold_call(lib, a, x, x_ms, x_cs, out, c_ptr, c_shift, G, R, P, n):
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.ring_fold(0, None if a is None else a.data_ptr(), x.data_ptr(),
                       x_ms, x_cs, out.data_ptr(), c_ptr, c_shift, G, R, P, n,
                       stream)
    assert rc == 0, rc


def host_us(fn, calls=2000):
    """Host microseconds a call of ``fn`` takes to return, at a size whose
    device time is shorter than that (so the launch queue never fills)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def guard(dev):
    with torch.cuda.device(dev):
        pass


def host_costs(lib, dev):
    """What one wrapper call costs the host, and its parts, in us."""
    x = torch.randn(4, 16, device=dev)
    out = torch.empty(4, 4, device=dev)
    chunks, recv = x[:, :4], torch.randn(4, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    entry = lib.ring_fold
    xp, op = x.data_ptr(), out.data_ptr()
    parts = {
        "ring_reduce_scatter wrapper": lambda: kring.ring_reduce_scatter(x),
        "ring_hop_accum wrapper": lambda: kring.ring_hop_accum(chunks, recv,
                                                               1),
        "C entry alone": lambda: entry(0, None, xp, 16, 4, op, None, 0, 4, 4,
                                       4, 4, stream),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "with torch.cuda.device": lambda: guard(dev),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch._C._cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "new_empty": lambda: x.new_empty(4, 4),
        "view(G, G, n).sum(0)": lambda: x.view(4, 4, -1).sum(0),
        "torch.add": lambda: torch.add(recv, chunks.select(0, 1)),
    }
    return {k: host_us(fn) for k, fn in parts.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc per variant
        built = dict(pool.map(build_variant, VARIANTS))
    for name, (_, regs) in built.items():
        print(f"{name}: {regs}")
    G = 4
    plan = cs.vgg_buckets(G)
    data = []
    for b in plan.buckets:
        N = b.padded_size
        data.append((torch.randn(N, device=dev).expand(G, N),
                     torch.randn(G, N, device=dev),
                     torch.empty(G, N // G, device=dev)))
    n = max(b.padded_size for b in plan.buckets) // G
    chunks, recv = torch.randn(G, n, device=dev), torch.randn(n, device=dev)
    hop_out = torch.empty(n, device=dev)
    cd = torch.tensor([1], dtype=torch.int32, device=dev)
    n_tot = sum(b.padded_size for b in plan.buckets)
    print(f"VGG-A's {len(data)} buckets at G = {G}: {n_tot} f32 elements; "
          f"bounds (bytes) stride-0 {cs.bytes_bound(8 * n_tot)} ms, distinct "
          f"{cs.bytes_bound(4 * (G + 1) * n_tot)} ms, hop at n = {n} "
          f"{cs.bytes_bound(12 * n)} ms [{card}]")

    def rs(lib, which):
        for stacks in data:
            x, out = stacks[which], stacks[2]
            fold_call(lib, None, x, x.stride(0), out.shape[1], out, None, 0,
                      G, G, G, out.shape[1])

    def hop(lib):
        fold_call(lib, recv, chunks, 0, chunks.stride(0), hop_out,
                  cd.data_ptr(), 0, G, 1, 1, n)

    def per_call(fns):
        """Sum of one CUDA-event median per call, as chip_smoke.py times
        the buckets: each includes the host's time to launch it."""
        return sum(cs.cuda_ms(fn, 3, 10) for fn in fns)

    print(f"host us a call at G = 4, n = 4: "
          f"{host_costs(built['shipped'][0], dev)}", flush=True)
    for rnd in range(2):   # every variant twice, in turn
        copies = [(s[0][0], torch.empty_like(s[0][0])) for s in data]
        base = {"copy (N in, N out)": graph_ms(
                    lambda: [o.copy_(i) for i, o in copies]),
                "view(G, G, n).sum(0), stride 0": graph_ms(
                    lambda: [s[0].view(G, G, -1).sum(0) for s in data]),
                "view(G, G, n).sum(0), distinct": graph_ms(
                    lambda: [s[1].view(G, G, -1).sum(0) for s in data]),
                "torch.add hop": graph_ms(
                    lambda: torch.add(recv, chunks.select(0, 1)))}
        del copies
        print(f"round {rnd} yardsticks, device time (CUDA graph): {base} "
              f"[{card}]", flush=True)
        wrap = {"stride-0": per_call(
                    [lambda x=s[0]: kring.ring_reduce_scatter(x)
                     for s in data]),
                "distinct": per_call(
                    [lambda x=s[1]: kring.ring_reduce_scatter(x)
                     for s in data]),
                "hop": per_call(
                    [lambda: kring.ring_hop_accum(chunks, recv, cd)]),
                "library stride-0": per_call(
                    [lambda x=s[0]: x.view(G, G, -1).sum(0) for s in data]),
                "library distinct": per_call(
                    [lambda x=s[1]: x.view(G, G, -1).sum(0) for s in data]),
                "torch.add": per_call(
                    [lambda: torch.add(recv, chunks.select(0, 1))])}
        print(f"round {rnd} the wrappers and library calls timed one call "
              f"at a time, as chip_smoke.py does: {wrap} [{card}]",
              flush=True)
        for name, (lib, _) in built.items():
            checked = ""
            if name in COMPUTES:
                for which in (0, 1):
                    for x, out in ((s[which], s[2]) for s in data):
                        fold_call(lib, None, x, x.stride(0), out.shape[1],
                                  out, None, 0, G, G, G, out.shape[1])
                        assert torch.equal(
                            out, kring.ring_reduce_scatter_plain(x)), name
                hop(lib)
                assert torch.equal(hop_out, kring.ring_hop_accum_plain(
                    chunks, recv, cd)), name
                checked = "; bitwise equal to the plain versions"
            t0 = graph_ms(lambda: rs(lib, 0))
            t1 = graph_ms(lambda: rs(lib, 1))
            th = graph_ms(lambda: hop(lib))
            print(f"round {rnd} {name}, device time (CUDA graph): "
                  f"reduce-scatter stride-0 {t0} ms, distinct {t1} ms; hop "
                  f"{th} ms{checked} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
