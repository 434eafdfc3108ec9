"""CPU tests of the benchmark: its files found by name, the operation
counts and the metric arithmetic, the modules it loads, and the port held
to the plain reference at smoke size."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench import check, flops, harness
from bench.tests._smoke import SEED, run_ranks, run_smoke, smoke_cell
from bench.trace import TraceSummary, kernel_class, summarize

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "bench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
SERIAL = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
MULTI = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_workload_finds_its_files(name):
    cell = harness.find_cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert set(cell.limits["limits"]) == {"loss_gap", "grad_gap",
                                          "change_gap", "grad_gap_median"}
    assert cell.family.products(cell.config)
    assert [m["name"] for m in cell.end_to_end] == [
        m["name"] for m in BENCH["end_to_end"]]
    for entry, reader in cell.per_layer:
        assert callable(reader.read), entry["name"]


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(WORKLOADS)
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["name"] in harness.E2E
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]


def test_operation_counts_by_hand():
    vgg = harness.find_cell("vgg_a.serial.b256")
    dnn = harness.find_cell("cd_dnn.serial.b1024")
    assert flops.forward_ops(vgg.family.products(vgg.config), 1,
                             "conv") == 14_970_912_768
    assert flops.forward_ops(dnn.family.products(dnn.config), 1) == 90_243_072
    # the classifier of VGG-A: 25088*4096 + 4096*4096 + 4096*1000 MACs
    assert flops.forward_ops(vgg.family.products(vgg.config), 1, "fc") == \
        2 * 123_633_664


def test_parameter_counts_are_the_published():
    import math
    vgg = harness.find_cell("vgg_a.serial.b256")
    dnn = harness.find_cell("cd_dnn.serial.b1024")
    assert sum(math.prod(s) for s in vgg.family.param_shapes(
        vgg.config).values()) == 132_863_336
    assert sum(math.prod(s) for s in dnn.family.param_shapes(
        dnn.config).values()) == 45_145_176


def test_roofline_and_mfu_arithmetic():
    cell = harness.find_cell("vgg_a.serial.b256")
    peaks = flops.PEAKS
    conv0 = ("conv", 224, 224, 3, 64, 3, 1, 1)
    ops, nbytes = flops.cost(conv0, 2)
    assert ops == 2 * 2 * 224 * 224 * 64 * 3 * 9
    assert nbytes == 4 * (2 * 224 * 224 * 3 + 9 * 3 * 64 + 2 * 224 * 224 * 64)
    # conv0 is bound by its bytes, conv05 by its operations
    assert flops.least_seconds(conv0, 2) == nbytes / peaks["hbm_bytes_per_s"]
    conv5 = ("conv", 56, 56, 256, 256, 3, 1, 1)
    assert flops.least_seconds(conv5, 2) == \
        flops.cost(conv5, 2)[0] / peaks["tf32_flop_per_s"]
    least_ms = 1e3 * sum(flops.least_seconds(p, 256)
                         for p in cell.family.products(cell.config)
                         if p[0] == "conv")
    trace = TraceSummary(steps=4, window_s=2.0, busy_s=1.5,
                         class_s={"conv_kernel": 4 * 0.080, "cudnn": 0.6})
    obs = {"cell": cell, "batch": 256, "rows": 256, "chips": 1, "steps": 100,
           "wall_s": 25.0, "trace": trace, "flops": flops,
           "host_ms": [1.0, 2.0, 3.0]}
    read = {m["name"]: r.read(obs) for m, r in cell.per_layer}
    assert read["conv_fwd_roofline"] == pytest.approx(100 * least_ms / 80.0)
    assert read["conv_bwd_ms"] == pytest.approx(150.0)
    assert read["idle_share"] == pytest.approx(25.0)
    assert read["host_ms_per_step"] == pytest.approx(2.0)
    model_ops = 3 * 256 * (14_970_912_768 + 2 * 123_633_664)
    assert read["step_mfu"] == pytest.approx(
        100 * model_ops * 100 / 25.0 / peaks["tf32_flop_per_s"])
    # 11.69 TFLOP a step of VGG-A at a batch of 256
    assert model_ops / 1e12 == pytest.approx(11.687, abs=1e-3)
    assert "gemm_fwd_roofline" not in read      # not this cell's metric


def test_a_reader_with_nothing_to_read_reports_nothing():
    cell = harness.find_cell("cd_dnn.serial.b1024")
    obs = {"cell": cell, "batch": 1024, "rows": 1024, "chips": 1,
           "steps": 10, "wall_s": 1.0, "flops": flops,
           "trace": TraceSummary(steps=2, window_s=1.0)}
    read = {m["name"]: r.read(obs) for m, r in cell.per_layer}
    assert read["gemm_fwd_roofline"] is None
    assert read["dnn_bwd_ms"] is None
    assert read["idle_share"] is None
    assert read["host_ms_per_step"] is None


class _Ev:
    def __init__(self, name, a, b, cuda, kernels=(), annotation=False):
        import torch
        self.name = name
        self.is_user_annotation = annotation
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"start": a, "end": b})
        self.kernels = [type("K", (), {"name": n, "duration": d})
                        for n, d in kernels]


SGEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_ffma__5x_cublas"


def test_trace_summary_of_a_synthetic_timeline():
    evs = [_Ev("void conv2d_nhwc_kernel<64>(...)", 0, 100, True),
           _Ev("cudnn::detail::dgrad_engine<float>", 90, 200, True),
           _Ev(SGEMM, 200, 300, True),
           _Ev("ncclDevKernel_SendRecv", 400, 450, True),
           _Ev(SGEMM, 500, 520, True),
           _Ev("bench.step", 0, 600, False),
           _Ev("bench.step", 0, 600, True),     # the range on the device
           _Ev("nccl:coalesced", 400, 450, True, annotation=True),
           _Ev("aten::convolution_backward", 80, 305, False,
               [("cudnn::detail::dgrad_engine<float>", 110), (SGEMM, 100)]),
           _Ev("aten::mm", 310, 390, False, [(SGEMM, 20)]),
           _Ev("cudaLaunchKernel", 460, 499, False)]
    s = summarize(evs, 2, evs[:5], 1e-3)
    assert s.busy_s == pytest.approx(370e-6) and s.window_s == 1e-3
    # the sgemm's 120 us split as its launches were: 100 from the conv's
    # backward, 20 from a product
    assert s.class_s == pytest.approx({"conv_kernel": 100e-6,
                                       "cudnn": 210e-6, "comm": 50e-6,
                                       "cublas": 20e-6})
    assert s.ms_per_step("cudnn") == pytest.approx(0.105)
    assert s.ms_per_step("gemm_kernel") is None
    assert s.device_ops[0][0] == SGEMM
    assert s.idle_gaps == [["aten::mm", pytest.approx(100e-6)],
                           ["cudaLaunchKernel", pytest.approx(50e-6)]]


@pytest.mark.parametrize("name,op,cls", [
    ("void conv2d_nhwc_kernel<128>(float const*)", "_Conv2d", "conv_kernel"),
    ("void blocked_matmul_kernel<float, 128, 64>(...)", "", "gemm_kernel"),
    ("void fold_kernel<float>(FoldArgs)", "", "comm"),
    ("ncclDevKernel_SendRecv(ncclDevComm*)", "nccl:send", "comm"),
    ("void fft2d_r2c_32x32<float>", "aten::convolution_backward", "cudnn"),
    (SGEMM, "aten::convolution_backward", "cudnn"),
    (SGEMM, "aten::mm", "cublas"),
    ("void at::native::elementwise_kernel<128, 2>", "aten::add_", "other"),
])
def test_kernel_classes(name, op, cls):
    assert kernel_class(name, op) == cls


def test_compare_takes_the_worst_leaf_and_leaves_out_small_ones():
    ref = check.Readings([2.0, 1.9, 1.8], {"a": 1.0, "b": 2.0, "c": 1e-6},
                         {"a": 3.0, "b": 1.0, "c": 1e-6})
    got = check.Readings([2.0, 1.9, 1.8 * (1 + 1e-5)],
                         {"a": 1.1, "b": 2.0, "c": 5.0},
                         {"a": 3.0, "b": 1.5, "c": 7.0})
    gaps = check.compare(got, ref)
    assert gaps["loss_gap"] == pytest.approx(1e-5)
    assert gaps["grad_gap"] == pytest.approx(0.1 / 1.5)   # median of a, b
    assert gaps["change_gap"] == pytest.approx(0.5 / 2.0)
    assert gaps["grad_gap_median"] == pytest.approx((0.1 / 1.5 + 0.0) / 2)
    nan = check.Readings([float("nan")] * 3, got.grad, got.change)
    assert check.compare(nan, ref)["loss_gap"] == check.NOT_FINITE


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    got = _modules_after(
        "import sys, json; sys.path[:0] = ['.']\n"
        "from bench import harness\n"
        "for f in ('cnn', 'dnn'):\n"
        "    harness.load_module(harness.BENCH / 'configs' / f'{f}.py', f)\n"
        "import bench.check, bench.flops, bench.trace\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not got & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    got = _modules_after(
        "import sys, json, time; sys.path[:0] = ['.', 'src']\n"
        "from bench.tests._smoke import run_smoke\n"
        "out = run_smoke('vgg_a.serial.b256', trace=True)\n"
        "assert out['correct'], out\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "repro_torch" in got
    assert not got & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("name", SERIAL)
@pytest.mark.parametrize("trace", [False, True])
def test_the_port_holds_to_the_reference_on_the_cpu(name, trace):
    out = run_smoke(name, trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    want = ({m["name"] for m in BENCH["end_to_end"]} if not trace else
            {"host_ms_per_step", "step_mfu"})
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", MULTI)
def test_the_zero1_ranks_hold_to_the_reference_on_the_cpu(name, tmp_path):
    out, loaded = run_ranks(name, 2, tmp_path)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2
    assert not loaded


def test_a_seed_gives_the_same_inputs():
    cell = smoke_cell("vgg_a.serial.b256")
    a = cell.family.make_batches(cell.config, 8, 4, SEED, "cpu")
    b = cell.family.make_batches(cell.config, 8, 4, SEED, "cpu")
    c = cell.family.make_batches(cell.config, 8, 4, SEED + 1, "cpu")
    assert all((x["images"] == y["images"]).all() for x, y in zip(a, b))
    assert not (a[0]["images"] == c[0]["images"]).all()
    assert not (a[0]["images"] == a[1]["images"]).all()
