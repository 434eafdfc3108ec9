"""What bounds the f32 flash-attention kernel on the card.

    python3 experiments/flash_f32_variants.py [OLD_FLASH_ATTENTION_CU]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``, each
with one substitution, into ``src/repro_torch/kernels/_build/variants/``
(one nvcc per variant, all at once), and times each f32 call (the K/V split
pass and the attention) through its C entry as a CUDA graph (the device's
time alone, no host time between launches), with its error against the
plain version (max |variant - plain| over 2e-5 max |plain|; <= 1 passes):

- ``shipped``: the source as it is (32-key K/V tiles; at D = 256 one
  consumer warpgroup and one stage of each ring, below two consumers and
  two or more stages; S promoted every 32 of the depth, two promotion
  runs in flight; P V into a fresh partial sum per tile and 64 columns);
- ``keys16``: 16-key tiles, so at D = 256 the other tiling that fits
  beside q's three pieces, two stages of each ring (a K/V load overlaps
  every product, but S's wgmma is m64n16), and more stages below;
- ``one_consumer``: one consumer warpgroup a CTA at every D;
- ``runs_serial``: each promotion run of S waited for before the next is
  issued;
- ``no_promotion``: S summed over the whole depth by the wgmmas, and each
  P V wgmma adding into O itself after the rescale;
- ``tf32x3``: at D <= 128, 3xTF32 on the same pipeline (three tf32
  products a product, the tensor time of the six bf16 ones; V transposed
  by the split pass and P through shared memory, since tf32 wgmma has no
  transpose bit and its A fragment orders k unlike the accumulator), from
  ``experiments/flash_tf32x3.cuh``;
- ``old``: the FFMA kernel the f32 instances ran before, built from
  ``OLD_FLASH_ATTENTION_CU`` (default: ``_checkout/parent/src/repro_torch/
  kernels/csrc/flash_attention.cu``, where a ``git archive`` of the parent
  commit is unpacked; skipped when absent);

beside ``F.scaled_dot_product_attention`` in f32 where the window is 0
(without the softcap, which it lacks; the variants are also timed so), and
the bound (six bf16 products at the tensor-core peak).  For ``shipped`` it
also splits one call's device time between its two kernels
(``torch.profiler``).  Shapes: ``chip_smoke.py``'s four model shapes.
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TK = "static constexpr int TK = 32;"
TF32X3 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "flash_tf32x3.cuh")
PV_FENCE = "        wgmma_fence();\n        static_for<0, TK / 16>"
PV_FOLD = ("        fence_regs(part);\n#pragma unroll\n        for (int j = 0; "
           "j < T::ON; ++j) o[c][j] = fmaf(o[c][j], alpha[(j >> 1) & 1], "
           "part[j]);")
VARIANTS = {
    "shipped": [],
    "keys16": [(TK, "static constexpr int TK = 16;")],
    "one_consumer": [("share each K/V tile\n  static constexpr int CONSUMERS "
                      "= D == 256 ? 1 : 2;", "share each K/V tile\n  static "
                      "constexpr int CONSUMERS = 1;")],
    "runs_serial": [("        wgmma_wait<1>();\n        fold(",
                     "        wgmma_wait<0>();\n        fold(")],
    "tf32x3": [   # the fragment goes in at the end of the namespace
        ("}  // namespace\n\n// dtype: 0", TF32X3),
        ("  return dispatch_f32(", "  return dispatch_tf32x3(")],
    "no_promotion": [
        ("constexpr int kPromoteSteps = 2;", "constexpr int kPromoteSteps = 1 << 10;"),
        (PV_FENCE, "#pragma unroll\n        for (int j = 0; j < T::ON; ++j) "
                   "o[c][j] *= alpha[(j >> 1) & 1];\n" + PV_FENCE),
        ("(part, pa[a][kk], dv, kk > 0 || j > 0)", "(o[c], pa[a][kk], dv, 1)"),
        (PV_FOLD, "        fence_regs(o[c]);")],
}
OLD = os.path.join(ROOT, "_checkout", "parent", "src", "repro_torch",
                   "kernels", "csrc", "flash_attention.cu")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_variant(job):
    """(key, (ctypes.CDLL, ptxas lines)); raises with nvcc's output."""
    key, source, subs = job
    out = os.path.join(build.BUILD_DIR, "variants", f"flash_{key}")
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(os.path.dirname(source), "hopper.cuh"), out)
    with open(source) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{key}: {old!r} is not in {source}")
        if new == TF32X3:
            with open(TF32X3) as f:
                new = f.read() + old
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
    # the parent's entry has no scratch argument
    lib.flash_attention.argtypes = ([P] * (4 if key == "old" else 5)
                                    + [I] * 8 + [F, F, I, P])
    lib.flash_attention.restype = I
    lines = [x for x in cs.build_lines(log) if "f32" in x or "warning" in x
             or "Performance Loss" in x]
    return key, (lib, lines)


class Call:
    """One f32 call of a model shape through a C entry, on buffers made
    once (so that it can be captured as a CUDA graph)."""

    def __init__(self, q, k, v, causal, window, softcap):
        self.q, self.k, self.v = q, k, v
        self.out = torch.empty_like(q)
        # 16 bytes an element of k: tf32x3's hi and lo of K and of V^T
        # (the bf16 pieces take 12)
        self.planes = torch.empty(8 * k.numel(), dtype=torch.bfloat16,
                                  device=q.device)
        B, Sq, Hq, D = q.shape
        self.dims = (B, Sq, k.shape[1], Hq, k.shape[2], D, int(causal),
                     int(window), float(softcap), float(D ** -0.5), 0)

    def __call__(self, key, lib):
        ptrs = [t.data_ptr() for t in (self.q, self.k, self.v)]
        if key != "old":
            ptrs.append(self.planes.data_ptr())
        rc = lib.flash_attention(*ptrs, self.out.data_ptr(), *self.dims,
                                 torch._C._cuda_getCurrentRawStream(0))
        assert rc == 0, f"{key}: CUDA error {rc}"
        return self.out


def kernel_split(call, lib):
    """Device ms of one shipped call's two kernels, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    reps = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call("shipped", lib)
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if "split_kv_kernel" in e.key or "flash_f32_kernel" in e.key:
            name = "split" if "split_kv_kernel" in e.key else "attention"
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            ms[name] = ms.get(name, 0.0) + total / 1e3 / reps
    return ms


def main():
    import torch.nn.functional as Fn
    print(f"card: {cs.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    source = str(build.CSRC / "flash_attention.cu")
    old = sys.argv[1] if len(sys.argv) > 1 else OLD
    jobs = [(key, source, subs) for key, subs in VARIANTS.items()]
    if os.path.exists(old):
        jobs.append(("old", old, []))
    else:
        print(f"no {old}: the old FFMA kernel is skipped")
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc per variant
        libs = dict(pool.map(build_variant, jobs))
    for key, (_, lines) in libs.items():
        for line in lines:
            print(f"  {key}: {line}")
    dev = torch.device("cuda")
    for name, B, S, Hq, Hkv, D, window, softcap in cs.FLASH_MODEL_SHAPES:
        q, k, v = cs.flash_inputs(dev, torch.float32, B, S, S, Hq, Hkv, D,
                                  S + D)
        bound_ms, bound_by, _ = cs.flash_bound(B, S, S, Hq, Hkv, D, True,
                                               window, torch.float32)
        caps = [softcap] + ([0.0] if window == 0 and softcap else [])
        for cap in caps:
            call = Call(q, k, v, True, window, cap)
            want = fa.flash_attention_plain(q, k, v, causal=True,
                                            window=window, logit_softcap=cap)
            print(f"{name}, Hq {Hq} Hkv {Hkv} D {D}, window {window}, "
                  f"softcap {cap}, f32: bound {bound_ms} ms ({bound_by}) "
                  f"[{cs.card_line()}]")
            for key, (lib, _) in libs.items():
                if key == "tf32x3" and D > 128:
                    continue   # its tiles do not fit
                r = cs.flash_ratio(call(key, lib), want)
                ms = cs.graph_ms(lambda: call(key, lib), 3, 20)
                print(f"  {key:18s} {ms} ms as a CUDA graph, error / "
                      f"tolerance {r}, bound / time {bound_ms / ms}")
            if "shipped" in libs:
                print(f"  shipped, one call's kernels (torch.profiler, ms): "
                      f"{kernel_split(call, libs['shipped'][0])}")
            if window == 0 and cap == 0.0:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

                def sdpa():
                    return Fn.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)
                print(f"  F.scaled_dot_product_attention f32 "
                      f"{cs.graph_ms(sdpa, 3, 20)} ms as a CUDA graph, "
                      f"{cs.cuda_ms(sdpa, 3, 20)} ms a call")
            del want
        del q, k, v


if __name__ == "__main__":
    main()
