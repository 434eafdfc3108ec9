"""What bounds the int8 wire kernels (``int8_quantize``, ``ring_hop_int8``)
on the card.

    python3 experiments/int8_wire_variants.py [OLD_RING_WIRE_CU]

Builds variants of ``src/repro_torch/kernels/csrc/ring_wire.cu``, each with
one substitution, into ``src/repro_torch/kernels/_build/variants/`` (one
nvcc per variant, all at once), and times each through its C entry as a
CUDA graph (the device's time alone, no host time between launches):

- ``shipped``: the source as it is (one cooperative launch a call: pass 1
  forward, a grid barrier, pass 2 backward with streaming loads and
  stores; 4 loads a thread in flight; the grid the card holds at once);
- ``forward_pass2``: pass 2 in pass 1's order;
- ``two_launch``: the same two passes as two ordinary launches (the block
  slots and the grid as shipped, no memset, no cooperative launch);
- ``loads_1`` / ``loads_2`` / ``loads_8``: loads a thread in flight;
- ``grid_half`` / ``grid_quarter``: half or a quarter of the blocks the
  card holds at once (``shipped`` is the largest cooperative grid);
- ``old``: the parent's design (a memset of the per-member maxima, a
  max-abs launch with ``atomicMax``, then a quantize launch), built from
  ``OLD_RING_WIRE_CU`` (default: ``_checkout/src/repro_torch/kernels/csrc/
  ring_wire.cu``, where a ``git archive`` of the parent is unpacked;
  skipped when absent);

beside ``Tensor.copy_`` of a quantize's bytes (f32 chunks in, int8 out,
one pass over them), the two-pass floor (the
inputs read twice: 9n and 11n bytes a member) and the byte bound (5n and
6n).  Shapes: VGG-A's 14 fusion buckets member-batched at G = 4 (the
stride-0 stacks of the zero1 path and G distinct partials), one member at
the largest chunk (fc13_w, n = 25,690,112), and the batched fc13_w and
fc14_w buckets alone.  The wrappers are also timed one call at a time, as
``chip_smoke.py`` times them (host time included), and the host's
microseconds a call, with its parts.  Needs one sm_90 card; prints the
card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from chip_smoke import graph_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402
from ring_fold_variants import host_us  # noqa: E402  (this directory's)

LOADS = "constexpr int kLoads = 4;"
REVERSE = ("for (long long t = blockIdx.x + (v.tiles - 1 - blockIdx.x) / B * B; "
           "t >= 0; t -= B) {")
HELD = "const long long held = resident(2 * vec + (q != nullptr));"
COOP = """  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&int8_wire_kernel<kVec, kHop>),
                                     grid, dim3(kThreads), args, 0, s);"""
TWO = """  int8_pass1_kernel<kVec, kHop><<<grid, kThreads, 0, s>>>(p);
  int8_pass2_kernel<kVec, kHop><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();"""
LAUNCH = "template <bool kVec, bool kHop>\ncudaError_t launch_int8("
TWO_KERNELS = """template <bool kVec, bool kHop>
__global__ void __launch_bounds__(kThreads) int8_pass1_kernel(WireArgs p) {
  int8_pass1<kVec, kHop>(p);
}
template <bool kVec, bool kHop>
__global__ void __launch_bounds__(kThreads) int8_pass2_kernel(WireArgs p) {
  int8_pass2<kVec, kHop>(p);
}

""" + LAUNCH
VARIANTS = {
    "shipped": [],
    "forward_pass2": [(REVERSE, "for (long long t = blockIdx.x; t < v.tiles; "
                                "t += B) {")],
    "two_launch": [(COOP, TWO), (LAUNCH, TWO_KERNELS)],
    "loads_1": [(LOADS, "constexpr int kLoads = 1;")],
    "loads_2": [(LOADS, "constexpr int kLoads = 2;")],
    "loads_8": [(LOADS, "constexpr int kLoads = 8;")],
    "grid_half": [(HELD, HELD.replace(";", " / 2;"))],
    "grid_quarter": [(HELD, HELD.replace(";", " / 4;"))],
}
OLD = os.path.join(ROOT, "_checkout", "src", "repro_torch", "kernels", "csrc",
                   "ring_wire.cu")
p_, i_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_variant(job):
    """(key, (ctypes.CDLL, register lines)); raises with nvcc's output."""
    key, source, subs = job
    out = os.path.join(build.BUILD_DIR, "variants", f"int8_{key}")
    os.makedirs(out, exist_ok=True)
    with open(source) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{key}: {old!r} is not in {source}")
        text = text.replace(old, new)
    src, so = os.path.join(out, "k.cu"), os.path.join(out, "k.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{key}: nvcc failed:\n{log}")
    lib = ctypes.CDLL(so)
    if key == "old":
        lib.ring_wire_int8.argtypes = [p_, ll_, ll_, p_, p_, ll_, i_, p_, p_,
                                       ll_, p_, p_, i_, i_, i_, ll_, p_]
    else:
        lib.ring_wire_int8.argtypes = [p_, ll_, ll_, p_, p_, ll_, i_, p_, p_,
                                       ll_, p_, ll_, p_, i_, i_, i_, ll_, p_]
        lib.ring_wire_int8_slots.argtypes = []
        lib.ring_wire_int8_slots.restype = ll_
    lib.ring_wire_int8.restype = i_
    regs = [x for x in cs.build_lines(log) if "registers" in x]
    return key, (lib, regs)


def stream():
    return torch._C._cuda_getCurrentRawStream(0)


class Call:
    """One int8 C call's arguments: a member-batched quantize or hop (step
    0) of a ``(G, N)`` stack, as the ``_members`` wrappers make it, or with
    ``one`` one member's call on ``(G, n)`` chunks, chunk 1 (as
    ``int8_quantize`` of it and ``ring_hop_int8`` at ``c = 1``)."""

    def __init__(self, st, msg=None, one=False):
        G, N = st.shape
        hop = msg is not None
        if one:
            n, M, o_ms = N, 1, 0
            x = (st.data_ptr(), 0, st.stride(0)) if hop else (st[1].data_ptr(), 0, 0)
            self.msg = (msg[0].data_ptr(), msg[1].data_ptr(), 0, 0) if hop else None
            self.c = (1, G) if hop else (0, 1)
        else:
            n, M, o_ms = N // G, G, N // G
            x = (st.data_ptr(), st.stride(0), n)
            self.msg = (msg[0].data_ptr(), msg[1].data_ptr(), n, -1) if hop else None
            self.c = (-2 if hop else -1, G)
        self.head = (x, o_ms)
        self.n, self.M = n, M
        self.st, self.src = st, msg
        self.out = torch.empty(M, n, dtype=torch.int8, device=st.device)
        self.s = torch.empty(M, device=st.device)
        self.amax = torch.empty(M, dtype=torch.int32, device=st.device)

    def __call__(self, lib, ws=None):
        (x, o_ms), (q, qs, q_ms, q_shift) = self.head, self.msg or (None, None, 0, 0)
        args = (*x, q, qs, q_ms, q_shift, self.out.data_ptr(), self.s.data_ptr(), o_ms)
        tail = (None, self.c[0], self.c[1], self.M, self.n, stream())
        if ws is None:       # the parent's entry: a scratch of per-member maxima
            rc = lib.ring_wire_int8(*args, self.amax.data_ptr(), *tail)
        else:
            rc = lib.ring_wire_int8(*args, ws.data_ptr(), ws.numel(), *tail)
        assert rc == 0, rc

    def check(self):
        """The last call's output against the plain version, bitwise."""
        st, msg = self.st, self.src
        if self.M == 1:
            want = (kring.int8_quantize_plain(st[1]) if msg is None else
                    kring.ring_hop_int8_plain(st, msg[0], msg[1], 1))
            got = (self.out[0], self.s)
        else:
            want = (kring.int8_quantize_members_plain(st) if msg is None else
                    kring.ring_hop_int8_members_plain(st, msg[0], msg[1], 0))
            got = (self.out, self.s)
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def host_costs(lib, dev):
    """What one wrapper call costs the host, and its parts, in us."""
    st = torch.randn(4, 16, device=dev)
    x = st[1]
    q, s = kring.int8_quantize_members(st)
    call = Call(st, (q, s))
    ws = torch.empty(kring._int8_slots(dev.index), dtype=torch.int32,
                     device=dev)
    parts = {
        "int8_quantize wrapper (n = 16)": lambda: kring.int8_quantize(x),
        "ring_hop_int8_members wrapper (G = 4, n = 4)":
            lambda: kring.ring_hop_int8_members(st, q, s, 0),
        "C entry alone (hop, G = 4)": lambda: call(lib, ws),
        "torch.empty (the block slots)": lambda: torch.empty(
            kring._int8_slots(dev.index), dtype=torch.int32, device=dev),
        "torch.empty_like (one output)": lambda: torch.empty_like(q),
        "the hop's checks": lambda: kring._check_message("q", q, (4, 4),
                                                         kring._I8),
    }
    return {k: host_us(fn) for k, fn in parts.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    old = sys.argv[1] if len(sys.argv) > 1 else OLD
    jobs = [(k, str(build.CSRC / "ring_wire.cu"), v) for k, v in VARIANTS.items()]
    if os.path.exists(old):
        jobs.append(("old", old, []))
    else:
        print(f"no {old}: the parent's design is not timed")
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc per variant
        built = dict(pool.map(build_variant, jobs))
    ws = {}
    for key, (lib, regs) in built.items():
        if key != "old":
            slots = lib.ring_wire_int8_slots()
            ws[key] = torch.empty(slots, dtype=torch.int32, device=dev)
        print(f"{key}: {regs}" + (f"; {ws[key].numel()} blocks held at once "
                                  "(the largest instance's)" if key in ws
                                  else ""))

    G = 4
    plan = cs.vgg_buckets(G)
    big = max(range(len(plan.buckets)), key=lambda i: plan.buckets[i].padded_size)
    sizes = [b.padded_size for b in plan.buckets]
    second = sorted(range(len(sizes)), key=lambda i: sizes[i])[-2]
    sets = {"stride0": [], "distinct": []}
    for N in sizes:
        g = torch.randn(N, device=dev)
        for name, st in (("stride0", g.expand(G, N)),
                         ("distinct", torch.randn(G, N, device=dev))):
            msg = kring.int8_quantize_members(st)
            sets[name].append((st, msg, Call(st), Call(st, msg)))
    n = sizes[big] // G
    chunks = torch.randn(G, n, device=dev)
    msg1 = kring.int8_quantize(chunks[3])
    one = {"quantize": Call(chunks, one=True),
           "hop": Call(chunks, msg1, one=True)}
    n_all = sum(sizes)
    bound = {"quantize": cs.bytes_bound(5 * n_all + 4 * G * len(sizes)),
             "hop": cs.bytes_bound(6 * n_all + 8 * G * len(sizes))}
    floor = {"quantize": cs.bytes_bound(9 * n_all), "hop": cs.bytes_bound(11 * n_all)}
    print(f"VGG-A's {len(sizes)} buckets at G = {G} ({n_all} f32 elements, "
          f"chunks {[N // G for N in sizes]}): bound (bytes, 5n / 6n) "
          f"quantize {bound['quantize']} ms, hop {bound['hop']} ms; two-pass "
          f"floor (9n / 11n) {floor['quantize']} / {floor['hop']} ms; fc13_w "
          f"batched (bucket {big}) bound {cs.bytes_bound(5 * sizes[big])} / "
          f"{cs.bytes_bound(6 * sizes[big])} ms, floor "
          f"{cs.bytes_bound(9 * sizes[big])} / {cs.bytes_bound(11 * sizes[big])}"
          f" ms; fc14_w batched (bucket {second}) bound "
          f"{cs.bytes_bound(5 * sizes[second])} / "
          f"{cs.bytes_bound(6 * sizes[second])} ms; one member at n = {n}: "
          f"bound {cs.bytes_bound(5 * n)} / {cs.bytes_bound(6 * n)} ms, floor "
          f"{cs.bytes_bound(9 * n)} / {cs.bytes_bound(11 * n)} ms [{card}]",
          flush=True)

    # every variant bitwise the plain version, at every shape it is timed at
    for key, (lib, _) in built.items():
        calls = [c for rows in sets.values() for r in rows for c in r[2:]]
        for call in calls + list(one.values()):
            call(lib, ws.get(key))
            assert call.check(), (key, call.st.shape, call.M)
    print(f"every variant bitwise equal to the plain version at every timed "
          f"shape: {list(built)}", flush=True)

    xc = [kring.member_chunks(st, -1).contiguous() for st, *_ in sets["distinct"]]
    qc = [torch.empty(x.shape, dtype=torch.int8, device=dev) for x in xc]
    print(f"host us a call: {host_costs(built['shipped'][0], dev)} [{card}]",
          flush=True)
    for rnd in range(2):   # every variant twice, in turn
        yard = {
            "copy_ f32 -> int8, 14 buckets": graph_ms(
                lambda: [o.copy_(x) for o, x in zip(qc, xc)]),
            "copy_ f32 -> int8, fc13_w batched": graph_ms(
                lambda: qc[big].copy_(xc[big])),
            "copy_ f32 -> int8, one member at fc13_w": graph_ms(
                lambda: one["quantize"].out[0].copy_(chunks[1]))}
        print(f"round {rnd} yardsticks, device time (CUDA graph): {yard} "
              f"[{card}]", flush=True)
        for name in ("stride0", "distinct"):
            rows = sets[name]
            wrap = {
                "quantize 14 buckets": sum(cs.cuda_ms(
                    lambda st=st: kring.int8_quantize_members(st), 3, 10)
                    for st, *_ in rows),
                "hop 14 buckets": sum(cs.cuda_ms(
                    lambda st=st, m=m: kring.ring_hop_int8_members(
                        st, m[0], m[1], 0), 3, 10) for st, m, *_ in rows)}
            print(f"round {rnd} {name} wrappers one call at a time (host time "
                  f"included, as chip_smoke.py times): {wrap} [{card}]",
                  flush=True)
        wrap1 = {"quantize": cs.cuda_ms(lambda: kring.int8_quantize(chunks[1]),
                                        3, 10),
                 "hop": cs.cuda_ms(lambda: kring.ring_hop_int8(
                     chunks, msg1[0], msg1[1], 1), 3, 10)}
        print(f"round {rnd} one member at fc13_w, wrappers one call at a "
              f"time: {wrap1} [{card}]", flush=True)
        for key, (lib, _) in built.items():
            w = ws.get(key)
            res = {}
            for name in ("stride0", "distinct"):
                rows = sets[name]
                res[f"{name} quantize 14"] = graph_ms(
                    lambda: [r[2](lib, w) for r in rows])
                res[f"{name} hop 14"] = graph_ms(
                    lambda: [r[3](lib, w) for r in rows])
            rows = sets["stride0"]
            res["fc13_w quantize"] = graph_ms(lambda: rows[big][2](lib, w))
            res["fc13_w hop"] = graph_ms(lambda: rows[big][3](lib, w))
            res["fc14_w quantize"] = graph_ms(lambda: rows[second][2](lib, w))
            res["fc14_w hop"] = graph_ms(lambda: rows[second][3](lib, w))
            res["one quantize"] = graph_ms(lambda: one["quantize"](lib, w))
            res["one hop"] = graph_ms(lambda: one["hop"](lib, w))
            small = [i for i, N in enumerate(sizes) if N // G <= 1024000]
            res["small stride0 quantize, per call"] = graph_ms(
                lambda: [rows[i][2](lib, w) for i in small]) / len(small)
            res["small stride0 hop, per call"] = graph_ms(
                lambda: [rows[i][3](lib, w) for i in small]) / len(small)
            print(f"round {rnd} {key}, device time (CUDA graph) ms: {res} "
                  f"[{card}]", flush=True)
            if key != "old":
                per = sum(cs.cuda_ms(lambda r=r: r[3](lib, w), 3, 10)
                          for r in rows)
                print(f"round {rnd} {key}, C entry one call at a time, "
                      f"stride0 hop 14 buckets: {per} ms [{card}]", flush=True)
            else:
                def old_like(r):
                    # as the parent's wrapper: outputs and scratch a call
                    r[3].out = torch.empty_like(r[3].out)
                    r[3].s = torch.empty_like(r[3].s)
                    r[3].amax = torch.empty_like(r[3].amax)
                    r[3](lib)
                per = sum(cs.cuda_ms(lambda r=r: old_like(r), 3, 10)
                          for r in rows)
                print(f"round {rnd} old, C entry one call at a time with the "
                      f"parent's three allocations, stride0 hop 14 buckets: "
                      f"{per} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
