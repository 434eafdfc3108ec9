"""The port's training CLI (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``): for the same argv, ``spec_from_args``
builds the same ``RunSpec`` fields (the one-process and the cluster form),
and ``check_run_args`` rejects the same flag combinations; what the port
does not run yet parses and raises in ``compile_run``; and the CLI trains
and resumes on the CPU.
"""
import argparse
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jtrain  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, assemble  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ARGVS = [
    ["--parallel", "serial"],
    ["--parallel", "zero1", "--comm-backend", "pallas-ring"],
    ["--parallel", "zero1", "--pods", "2", "--bucket-mb", "1",
     "--wire-dtype", "bf16", "--overlap"],
    ["--parallel", "zero1", "--wire-format", "topk", "--topk-ratio", "0.1",
     "--cross-backend", "pallas-ring"],
    ["--parallel", "zero1", "--comm", "auto", "--trace-dir", "/tmp/t"],
    ["--parallel", "stale-sync", "--wire-format", "int8"],
    ["--parallel", "gossip", "--wire-dtype", "bf16"],
    ["--parallel", "dp", "--ckpt-dir", "/tmp/c", "--steps", "12"],
    ["--parallel", "zero1", "--ckpt-dir", "/tmp/c", "--ckpt-every", "3",
     "--schedule", "linear-scale-warmup", "--optimizer", "adamw",
     "--model-ways", "2", "--seed", "3", "--seq", "64", "--lr", "0.01"],
]

BAD = [
    ["--parallel", "serial", "--overlap"],
    ["--parallel", "dp", "--comm-backend", "pallas-ring"],
    ["--parallel", "zero1", "--comm", "auto", "--bucket-mb", "2"],
    ["--parallel", "serial", "--comm", "auto"],
    ["--parallel", "stale-sync", "--overlap"],
    ["--parallel", "zero1", "--comm-backend", "gossip"],
    ["--parallel", "stale-sync", "--wire-format", "topk"],
    ["--parallel", "zero1", "--wire-format", "topk", "--overlap"],
]


def _parse(mod, argv):
    ap = argparse.ArgumentParser()
    mod.add_run_args(ap)
    args = ap.parse_args(["--arch", "vgg-a", "--smoke", *argv])
    mod.check_run_args(ap, args)
    return args


def _fields(spec):
    out = {k: getattr(spec, k) for k in (
        "arch", "smoke", "parallel", "optimizer", "lr", "schedule", "steps",
        "batch", "seq", "seed", "log_every", "ckpt_every", "ckpt_dir")}
    out["mesh"] = (spec.mesh.pods, spec.mesh.model_ways, spec.mesh.cluster)
    out["comm"] = spec.comm if spec.comm in (None, "auto") \
        else dataclasses.asdict(spec.comm)
    out["telemetry"] = getattr(spec.telemetry, "trace_dir", None)
    return out


@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_spec_from_args_matches_the_reference(argv, cluster):
    got = train.spec_from_args(_parse(train, argv), cluster=cluster)
    want = jtrain.spec_from_args(_parse(jtrain, argv), cluster=cluster)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("argv", BAD, ids=[" ".join(a) for a in BAD])
def test_check_run_args_rejects_what_the_reference_rejects(argv):
    for mod in (jtrain, train):
        with pytest.raises(SystemExit):
            _parse(mod, argv)


# dp, zero1-gspmd and model ways on every family and mesh are ported: the
# cases are model ways on a cluster (an LM's and a CNN's), which at one
# process of one local device clamp to one way as the reference's do, what
# the port still refuses, model ways with --overlap, and the default (dp,
# as the reference's)
@pytest.mark.parametrize("argv", [
    [], ["--arch", "llama-100m", "--parallel", "dp", "--model-ways", "2",
         "--cluster"],
    ["--parallel", "zero1", "--model-ways", "2", "--cluster"],
    ["--parallel", "zero1", "--model-ways", "2", "--overlap"]],
    ids=["default", "dp", "auto", "model_ways"])
def test_unported_flags_parse_then_raise_in_compile_run(argv, monkeypatch):
    def no_device(*a, **k):
        raise AssertionError("compile_run reached the device")
    monkeypatch.setattr(assemble, "resolve_device", no_device)
    cluster = "--cluster" in argv
    argv = [a for a in argv if a != "--cluster"]
    if not argv:
        # the default mode is the reference's, dp, which the port runs
        args, jargs = _parse(train, argv), _parse(jtrain, argv)
        assert args.parallel == jargs.parallel == "dp"
        assert _fields(train.spec_from_args(args)) \
            == _fields(jtrain.spec_from_args(jargs))
        return
    # a later --arch overrides _parse's vgg-a
    spec = train.spec_from_args(_parse(train, argv), cluster=cluster)
    if "--overlap" in argv:
        with pytest.raises(ValueError, match="requires model_ways == 1"):
            assemble.compile_run(spec)
        return
    monkeypatch.undo()
    assert spec.mesh.cluster and spec.mesh.model_ways == 2
    with assemble.compile_run(spec, device="cpu") as run:
        assert run.mesh.shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("argv", [
    ["--parallel", "stale-sync", "--comm-backend", "pallas-ring",
     "--pods", "2"],
    ["--parallel", "gossip", "--pods", "2"],
    ["--parallel", "zero1", "--comm", "auto", "--pods", "2"]],
    ids=["stale-sync", "gossip", "auto"])
def test_cli_trains_the_ported_modes(argv, capsys):
    hist = train.main(["--arch", "vgg-a", "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "4", "--schedule",
                       "constant", *argv])
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert f"parallel={argv[1]}" in out and "final loss" in out
    if "gossip" in argv:
        assert "backend=gossip" in out
    if "auto" in argv:
        assert "comm=auto: G=2" in out and "not a link" in out


def test_cli_trains_then_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--arch", "vgg-a", "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "4", "--schedule", "constant", "--parallel", "zero1",
            "--pods", "2", "--comm-backend", "pallas-ring",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    hist = train.main(argv)
    assert [h["step"] for h in hist][-1] == 4
    assert train.main(argv) == []
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 4" in out
    assert "nothing to train" in out


@pytest.mark.parametrize("argv,want", [
    ([], ("pallas-ring", "pallas-ring")),
    (["--comm-backend", "lax"], ("lax", "pallas-ring")),
    (["--cross-backend", "lax"], ("pallas-ring", "lax")),
    (["--parallel", "serial"], ("lax", None))],
    ids=["default", "lax in-pod", "lax cross-pod", "serial"])
def test_cluster_cli_takes_the_ring_at_both_levels_of_zero1(argv, want):
    from repro_torch.launch import cluster
    ap = cluster.make_parser()
    args = ap.parse_args(["--arch", "vgg-a", "--smoke", *argv])
    cluster.resolve_comm_backends(args)
    train.check_run_args(ap, args)
    assert (args.comm_backend, args.cross_backend) == want
    spec = train.spec_from_args(args, cluster=True)
    if args.parallel == "zero1":
        assert (spec.comm.hierarchical, spec.comm.backend,
                spec.comm.cross_backend) == (True, *want)
    else:
        assert spec.comm is None


@pytest.mark.parametrize("argv,refused", [
    (["--cross-backend", "lax"], True),
    (["--cross-backend", "lax", "--device", "cpu"], False),
    (["--cross-backend", "lax", "--processes", "1"], False),
    (["--cross-backend", "lax", "--wire-format", "int8"], False),
    ([], False)],
    ids=["card", "cpu", "one process", "int8", "default"])
def test_cluster_cli_refuses_host_sums_of_card_buffers(argv, refused):
    # the plain reduce-scatter over gloo would sum a card's buffers in host
    # memory; refused before any worker starts, since the supervisor would
    # otherwise shrink the world until one process trains alone
    from repro_torch.launch import cluster
    ap = cluster.make_parser()
    args = ap.parse_args(["--arch", "vgg-a", "--smoke", *argv])
    cluster.resolve_comm_backends(args)
    if refused:
        with pytest.raises(SystemExit):
            cluster.check_cluster_args(ap, args)
    else:
        cluster.check_cluster_args(ap, args)


def test_compile_run_of_a_cluster_takes_the_ring_at_both_levels():
    # comm=None under cluster: hierarchical, as the reference's cluster CLI
    # makes it, on the ring backend, which adds on the card over gloo
    run = assemble.compile_run(RunSpec(
        arch="vgg-a", smoke=True, parallel="zero1",
        mesh=MeshSpec(cluster=True)), device="cpu")
    assert (run.comm.hierarchical, run.comm.backend,
            run.comm.cross_backend) == (True, "pallas-ring", "pallas-ring")
    run.close()


def test_hold_f32_turns_tf32_off_for_a_card_only():
    from repro_torch.device import hold_f32
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        hold_f32(torch.device("cpu"))
        assert all(f.allow_tf32 for f in flags)
        hold_f32(torch.device("cuda", 0))
        assert not any(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s]|$)", re.M)


def test_port_and_chip_smoke_import_no_jax_nor_the_reference():
    """No module of the port, and not ``chip_smoke.py``, names ``jax`` or
    the reference package in an import; and importing every module of the
    port loads neither."""
    root = os.path.join(os.path.dirname(__file__), "..")
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            found = IMPORT.findall(f.read())
        assert not found, f"{path} imports {found}"
    code = ("import pkgutil, importlib, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=dict(
                             os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr[-3000:]


def test_cli_use_kernel_routes_the_forward_and_counts_launches(
        tmp_path, monkeypatch, capsys):
    """``--use-kernel`` puts the forward on the kernel's wrapper (on the
    CPU its plain version, so the same losses), and the trace's closing
    metrics carry the kernels' launches as ``launches/<kernel>`` counters
    (here stand-in counts: on the CPU no kernel launches)."""
    import repro_torch.kernels as kernels
    from repro_torch import telemetry as tel
    from repro_torch.launch import paper_cnn_training
    routed = []
    real = paper_cnn_training.use_kernel
    monkeypatch.setattr(paper_cnn_training, "use_kernel",
                        lambda run: routed.append(run) or real(run))
    monkeypatch.setattr(kernels, "launch_counts",
                        lambda: {"conv2d_nhwc": 16, "ring_hop_accum": 0})
    argv = ["--arch", "vgg-a", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--schedule", "constant"]
    plain = train.main(argv)
    trace = str(tmp_path / "trace")
    hist = train.main([*argv, "--use-kernel", "--trace-dir", trace])
    assert len(routed) == 1 and "kernel=True" in capsys.readouterr().out
    assert [h["loss"] for h in hist] == pytest.approx(
        [h["loss"] for h in plain], rel=1e-6)
    metrics = tel.read_jsonl(tel.trace_path(trace, 0))[-1]
    assert metrics["kind"] == "metrics"
    assert metrics["counters"]["launches/conv2d_nhwc"] == 16
    assert "launches/ring_hop_accum" not in metrics["counters"]
