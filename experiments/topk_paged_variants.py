"""What bounds the top-k hop and the paged-decode kernel on the card.

    python3 experiments/topk_paged_variants.py [OLD_PAGED_ATTN_CU [OLD_RING_WIRE_CU]]

Builds variants of ``src/repro_torch/kernels/csrc/ring_wire.cu`` and
``csrc/paged_attn.cu``, each with one substitution, into
``src/repro_torch/kernels/_build/variants/`` (one nvcc per variant, all at
once), and times each through its C entry as a CUDA graph of its launches
(the device's time alone, no host time between launches).

Top-k hop (``ring_hop_topk``, ratio 0.05), member-batched over VGG-A's 14
fusion buckets at G = 4 and one member's call at the largest chunk (fc13_w,
n = 25,690,112, k = 1,284,506):

- ``shipped``: the source as it is (the dense pass and then the scatter
  over each range of 8 Mi elements of out, 4 entries a thread in the
  scatter, their loads before any store);
- ``range_4m`` / ``range_16m``: ranges of 4 or 16 Mi elements;
- ``one_range``: one range however large (the dense pass over all of out,
  then the scatter: its read-modify-writes go to DRAM at fc13_w);
- ``scatter_1`` / ``scatter_8``: 1 or 8 entries a thread;
- ``cas``: each entry added by a compare-and-swap loop (the first design's
  add) in place of the load and store;
- ``dense_grid_4096`` / ``dense_grid_256``: the dense pass on up to 4096
  or 256 blocks a launch (1024 shipped);
- ``dense_only`` / ``scatter_only``: one of each range's two launches alone;
- ``old``: the first design (the dense pass, then a compare-and-swap loop
  per entry), built from ``OLD_RING_WIRE_CU`` (default: the parent's copy
  under ``_checkout/``, as for the paged kernel; skipped when absent);

beside a copy of the same dense bytes (``Tensor.copy_``) and ``index_add``
(the library call ``chip_smoke.py`` names: one call over the flattened
members for the batched form).

Paged decode at the serving shapes (llama3-8b's heads, B 4, 34 pages of
16; phase 1's lengths and a live decode step's) and at a long context (4 x
4096 positions):

- ``shipped`` at every split size (pages a split) from 1 to the table;
- ``batch_2`` / ``batch_8``: 2 or 8 row groups a warp in flight (4 shipped);
- ``warps_2`` / ``warps_8``: 64 or 256 threads a block (128 shipped);
- ``split_only`` / ``combine_only``: one of the call's two launches alone;
- ``old``: the first design (one block per request and kv head), built from
  ``OLD_PAGED_ATTN_CU`` (default: ``_checkout/src/repro_torch/kernels/csrc/
  paged_attn.cu``, where a ``git archive`` of the parent is unpacked;
  skipped when absent);

beside the plain gather version (many library launches, also as a graph)
and the byte bound.  The wrappers are also timed one call at a time, as
``chip_smoke.py`` times them (host time included).  Needs one sm_90 card;
prints the card's name and power limit first.
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
from repro_torch.comm.backends.ring import _topk_select, topk_chunk_k  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attn  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402

DENSE = ("    if (vec)\n      topk_dense_kernel<true><<<grid, kThreads, 0, s>>>(p, lo, hi);\n"
         "    else\n      topk_dense_kernel<false><<<grid, kThreads, 0, s>>>(p, lo, hi);\n")
STORE = "if (i[u] >= 0) o[i[u]] = __fadd_rn(cur[u], v[u]);"
CAS = """__device__ __forceinline__ void add_exact(float* addr, float v) {
  unsigned* word = reinterpret_cast<unsigned*>(addr);
  unsigned old = *word, seen;
  do {
    seen = old;
    old = atomicCAS(word, seen, __float_as_uint(__fadd_rn(__uint_as_float(seen), v)));
  } while (old != seen);
}

// out[idx[j]] += vals[j] for the entries"""
RANGE = "constexpr long long kRange = 8LL << 20;"
TOPK = {
    "shipped": [],
    "range_4m": [(RANGE, "constexpr long long kRange = 4LL << 20;")],
    "range_16m": [(RANGE, "constexpr long long kRange = 16LL << 20;")],
    "one_range": [(RANGE, "constexpr long long kRange = 1LL << 40;")],
    "scatter_1": [("constexpr int kScatter = 4;", "constexpr int kScatter = 1;")],
    "scatter_8": [("constexpr int kScatter = 4;", "constexpr int kScatter = 8;")],
    "cas": [("// out[idx[j]] += vals[j] for the entries", CAS),
            (STORE, "if (i[u] >= 0) add_exact(o + i[u], v[u]);")],
    "dense_grid_4096": [("constexpr long long kMaxBlocks = 1024;",
                         "constexpr long long kMaxBlocks = 4096;")],
    "dense_grid_256": [("constexpr long long kMaxBlocks = 1024;",
                        "constexpr long long kMaxBlocks = 256;")],
    "dense_only": [("    if (k > 0)\n      topk_scatter_kernel",
                    "    if (false)\n      topk_scatter_kernel")],
    "scatter_only": [(DENSE, "")],
}
TOPK_COMPUTES = ("shipped", "range_4m", "range_16m", "one_range", "scatter_1",
                 "scatter_8", "cas", "dense_grid_4096", "dense_grid_256", "old")
COMBINE = ("  paged_combine_kernel<T><<<B * Hq, kCombineThreads, sizeof(float) * S, "
           "stream>>>(\n      part_ml, part_acc, static_cast<T*>(out), D, S);\n")
SPLIT = "  paged_split_kernel<T, H><<<grid, kThreads, smem, stream>>>("
PAGED = {
    "shipped": [],
    "batch_2": [("constexpr int kBatch = 4;", "constexpr int kBatch = 2;")],
    "batch_8": [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "warps_2": [("constexpr int kThreads = 128;", "constexpr int kThreads = 64;")],
    "warps_8": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
    "split_only": [(COMBINE, "  if (false)\n" + COMBINE)],
    "combine_only": [(SPLIT, "  if (false)\n" + SPLIT)],
}
OLD = os.path.join(ROOT, "_checkout", "src", "repro_torch", "kernels", "csrc")
p_, i_, ll_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def build_variant(job):
    """(key, (ctypes.CDLL, register lines)); raises with nvcc's output."""
    key, source, subs = job
    out = os.path.join(build.BUILD_DIR, "variants", key)
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
    if key.startswith("topk"):
        lib.ring_wire_topk.argtypes = [p_, ll_, ll_, p_, p_, ll_, i_, ll_, p_,
                                       ll_, p_, i_, i_, i_, ll_, p_]
        lib.ring_wire_topk.restype = i_
    elif key == "paged_old":
        lib.paged_decode_attention.argtypes = [p_] * 6 + [i_] * 8 + [
            f_, f_, i_, p_]
        lib.paged_decode_attention.restype = i_
    else:
        lib.paged_decode_attention.argtypes = [p_] * 7 + [i_] * 9 + [
            f_, f_, i_, p_]
        lib.paged_decode_attention.restype = i_
    regs = [x for x in cs.build_lines(log) if "registers" in x]
    return key, (lib, regs)


def stream():
    return torch.cuda.current_stream().cuda_stream


def graph_ms(fn):
    """CUDA-event median of one replay of ``fn`` captured as a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cs.cuda_ms(graph.replay, 3, 20)


def topk_call(lib, st, vals, idx, out, step):
    """The member-batched hop's C call (as ``ring_hop_topk_members``)."""
    G, N = st.shape
    n, k = N // G, vals.shape[1]
    rc = lib.ring_wire_topk(st.data_ptr(), st.stride(0), n, vals.data_ptr(),
                            idx.data_ptr(), k, -1, k, out.data_ptr(), n, None,
                            -2 - step, G, G, n, stream())
    assert rc == 0, rc


def topk_one(lib, chunks, vals, idx, out, c):
    """One member's hop (as ``ring_hop_topk`` with a host chunk index)."""
    G, n = chunks.shape
    rc = lib.ring_wire_topk(chunks.data_ptr(), 0, chunks.stride(0),
                            vals.data_ptr(), idx.data_ptr(), 0, 0,
                            vals.shape[0], out.data_ptr(), 0, None, c, G, 1,
                            n, stream())
    assert rc == 0, rc


def topk_section(built, card):
    G = 4
    plan = cs.vgg_buckets(G)
    dev = torch.device("cuda")
    data = []
    for b in plan.buckets:
        N = b.padded_size
        n = N // G
        k = topk_chunk_k(n, cs.TOPK_RATIO)
        st = torch.randn(G, N, device=dev)
        vals, idx = _topk_select(kring.member_chunks(st, -1), k)
        # step 0: member m adds row m - 1 of the message to its chunk m - 2
        flat = idx.roll(1, 0).long() + torch.arange(G, device=dev)[:, None] * n
        data.append((st, vals, idx, torch.empty(G, n, device=dev),
                     flat.reshape(-1), vals.roll(1, 0).reshape(-1),
                     kring.member_chunks(st, -2).contiguous()))
    n = max(b.padded_size for b in plan.buckets) // G
    k = topk_chunk_k(n, cs.TOPK_RATIO)
    chunks = torch.randn(G, n, device=dev)
    vals1, idx1 = _topk_select(torch.randn(n, device=dev), k)
    idx64 = idx1.long()
    out1 = torch.empty(n, device=dev)
    nb = sum(4 * d[0].shape[1] + 8 * d[1].numel() for d in data)
    print(f"top-k: VGG-A's {len(data)} buckets at G = {G}, ratio "
          f"{cs.TOPK_RATIO}: bound (bytes: 4n + 8k + 4n a member) "
          f"{cs.bytes_bound(nb)} ms summed; one member at n = {n}, k = {k}: "
          f"{cs.bytes_bound(8 * n + 8 * k)} ms [{card}]", flush=True)
    yard = {
        "copy (dense bytes)": (
            lambda: [d[3].copy_(d[6]) for d in data],
            lambda: out1.copy_(chunks[1])),
        "index_add": (
            lambda: [d[6].reshape(-1).index_add(0, d[4], d[5]) for d in data],
            lambda: chunks[1].index_add(0, idx64, vals1)),
    }
    wrappers = (
        lambda: [kring.ring_hop_topk_members(d[0], d[1], d[2], 0)
                 for d in data],
        lambda: kring.ring_hop_topk(chunks, vals1, idx1, 1))
    for rnd in range(2):
        for name, (fb, f1) in yard.items():
            print(f"round {rnd} top-k {name}, device time (CUDA graph): 14 "
                  f"buckets {graph_ms(fb)} ms, one member at fc13_w "
                  f"{graph_ms(f1)} ms [{card}]", flush=True)
        per = [sum(cs.cuda_ms(lambda d=d: kring.ring_hop_topk_members(
                   d[0], d[1], d[2], 0), 3, 10) for d in data),
               cs.cuda_ms(wrappers[1], 3, 10),
               sum(cs.cuda_ms(lambda d=d: d[6].reshape(-1).index_add(
                   0, d[4], d[5]), 3, 10) for d in data),
               cs.cuda_ms(yard["index_add"][1], 3, 10)]
        print(f"round {rnd} top-k one call at a time (host time included, "
              f"as chip_smoke.py times): wrapper 14 buckets {per[0]} ms, "
              f"one member {per[1]} ms; index_add {per[2]} / {per[3]} ms "
              f"[{card}]", flush=True)
        for name in [*TOPK, "old"]:
            if f"topk_{name}" not in built:
                continue
            lib = built[f"topk_{name}"][0]
            checked = ""
            if name in TOPK_COMPUTES:
                for d in data:
                    topk_call(lib, d[0], d[1], d[2], d[3], 0)
                    assert torch.equal(d[3], kring.ring_hop_topk_members_plain(
                        d[0], d[1], d[2], 0)), name
                topk_one(lib, chunks, vals1, idx1, out1, 1)
                assert torch.equal(out1, kring.ring_hop_topk_plain(
                    chunks, vals1, idx1, 1)), name
                checked = "; bitwise equal to the plain version"
            tb = graph_ms(lambda: [topk_call(lib, d[0], d[1], d[2], d[3], 0)
                                   for d in data])
            t1 = graph_ms(lambda: topk_one(lib, chunks, vals1, idx1, out1, 1))
            print(f"round {rnd} top-k {name}, device time (CUDA graph): 14 "
                  f"buckets {tb} ms, one member at fc13_w {t1} ms{checked} "
                  f"[{card}]", flush=True)


def paged_call(lib, q, pk, pv, pt, ln, out, scratch, pps):
    B, Hq, D = q.shape
    P, ps, Hkv, _ = pk.shape
    rc = lib.paged_decode_attention(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), pt.data_ptr(),
        ln.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, P,
        ps, pt.shape[1], pps, 0, 0.0, D ** -0.5, 1, stream())
    assert rc == 0, rc


def paged_old(lib, q, pk, pv, pt, ln, out):
    B, Hq, D = q.shape
    P, ps, Hkv, _ = pk.shape
    rc = lib.paged_decode_attention(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), pt.data_ptr(),
        ln.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, P, ps, pt.shape[1], 0,
        0.0, D ** -0.5, 1, stream())
    assert rc == 0, rc


def paged_section(built, card):
    dev = torch.device("cuda")
    ps = 16
    cases = [("serving, phase 1's lengths", 34, [1, 16, 300, 544]),
             ("serving, a live step's lengths", 34, [446, 371, 475, 207]),
             ("long context", 256, [4096] * 4)]
    for rnd in range(2):
        for title, n, lengths in cases:
            q, pk, pv, pt, ln = cs.paged_inputs(dev, 4, 32, 8, 128, ps, n,
                                                4 * n + 16, lengths, seed=n)
            out = torch.empty_like(q)
            want = paged_attn.paged_decode_attention_plain(q, pk, pv, pt, ln)
            bound, _ = cs.paged_bound(q, pk, pt, lengths, 0)
            res = {"plain (graph)": graph_ms(
                lambda: paged_attn.paged_decode_attention_plain(
                    q, pk, pv, pt, ln))}
            if "paged_old" in built:
                lib = built["paged_old"][0]
                paged_old(lib, q, pk, pv, pt, ln, out)
                res["old"] = (graph_ms(lambda: paged_old(
                    lib, q, pk, pv, pt, ln, out)),
                    (out.float() - want.float()).abs().max().item())
            chosen = paged_attn.split_pages(4, 8, 4, n)
            for pps in sorted({1, 2, 3, 4, 8, 16, 32, n, chosen}):
                if pps > n:
                    continue
                S = -(-n // pps)
                scratch = torch.empty(4 * 32 * S * 130, device=dev)
                for name in PAGED:
                    if name != "shipped" and pps != chosen:
                        continue
                    if name in ("split_only", "combine_only"):
                        res[f"{name} pps={pps}"] = graph_ms(
                            lambda: paged_call(built[f"paged_{name}"][0], q,
                                               pk, pv, pt, ln, out, scratch,
                                               pps))
                        continue
                    lib = built[f"paged_{name}"][0]
                    paged_call(lib, q, pk, pv, pt, ln, out, scratch, pps)
                    err = (out.float() - want.float()).abs().max().item()
                    res[f"{name} pps={pps}"] = (graph_ms(
                        lambda: paged_call(lib, q, pk, pv, pt, ln, out,
                                           scratch, pps)), err)
            res["wrapper, one call at a time"] = cs.cuda_ms(
                lambda: paged_attn.paged_decode_attention(q, pk, pv, pt, ln))
            res["plain, one call at a time"] = cs.cuda_ms(
                lambda: paged_attn.paged_decode_attention_plain(
                    q, pk, pv, pt, ln), 3, 10)
            print(f"round {rnd} paged decode, {title} {lengths} (B 4, Hq 32, "
                  f"Hkv 8, D 128, ps 16, n {n}; the wrapper's split {chosen} "
                  f"pages): bound {bound} ms; device time (CUDA graph) ms and "
                  f"max|err| against the plain version: {res} [{card}]",
                  flush=True)
            del q, pk, pv, pt, ln, out, want


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    olds = {"paged_old": os.path.join(OLD, "paged_attn.cu"),
            "topk_old": os.path.join(OLD, "ring_wire.cu")}
    for key, arg in zip(olds, sys.argv[1:]):
        olds[key] = arg
    jobs = [(f"topk_{k}", str(build.CSRC / "ring_wire.cu"), v)
            for k, v in TOPK.items()]
    jobs += [(f"paged_{k}", str(build.CSRC / "paged_attn.cu"), v)
             for k, v in PAGED.items()]
    for key, path in olds.items():
        if os.path.exists(path):
            jobs.append((key, path, []))
        else:
            print(f"no {path}: {key} is not timed")
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc per variant
        built = dict(pool.map(build_variant, jobs))
    for key, (_, regs) in built.items():
        print(f"{key}: {regs}")
    topk_section(built, card)
    paged_section(built, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
