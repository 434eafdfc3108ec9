"""The paper's §3.3 hybrid data/model parallelism in the port (a "model"
axis on both meshes, ``parallel="dp"`` and ``"zero1-gspmd"``, the hybrid
planner) against the JAX package, on the CPU.

The reference runs on 4 forced host devices (``{data: 2, model: 2}`` at
model_ways 2, ``{data: 4}`` at 1), in subprocesses started together when
this module begins, so that they run while the module's other tests do:

- ``paper``: cd-dnn and vgg-a (smoke) under dp, zero1-gspmd and zero1
  (pallas-ring) at model_ways 2, 2 steps: initial and final params,
  losses, grad norms, the GSPMD placement of params and state, and
  checkpoints of cd-dnn at model_ways 2 and 1;
- ``archs0..4``: every arch (smoke) under dp and zero1-gspmd at model_ways
  1, 2 steps;
- ``resume``: the port's cd-dnn checkpoints, written at model_ways 2 and 1,
  resumed in the reference at 2 -> 2, 2 -> 1 and 1 -> 2.

The port starts from the reference's params (``Run.load_params``); both
packages draw the same batches from the seeded streams.

Tolerances:
- CD-DNN and VGG-A losses and grad norms within 1e-5 relative per step and
  final params within rtol 1e-5, atol 1e-6 (``tests/test_torch_dnn.py``'s
  and ``tests/test_torch_dist.py``'s: f32 layers summed in another order);
  measured against the reference's own serial run the reference's hybrid
  runs sit within 1e-8.
- the LMs' losses within 1e-3 relative and grad norms within 1e-2
  (``tests/test_torch_lm_fit.py``'s: bf16 activations round at other
  places in the two frameworks); zamba2 and xlstm on f32 activations in
  both packages, as ``tests/test_torch_families.py`` fits zamba2 (on bf16
  their second losses part by 2.2e-3 and 1.8e-3).
- checkpoints: keys and full shapes equal to the reference's; a resumed run
  within rtol 1e-5, atol 1e-6 of an uninterrupted one (2 steps in another
  package from the same state).
- the gloo process mesh against the local mesh: params within 1e-6 (each
  rank's half batch sums in another order).
- hybrid.plan and the demo's §3.3 numbers: exact.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from _gloo_ranks import run_ranks  # noqa: E402
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES  # noqa: E402
from repro.configs import TPU_V5E as J_TPU_V5E  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import balance as jbalance  # noqa: E402
from repro.core import hybrid as jhybrid  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ALL_ARCHS,
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    get_config,
)
from repro_torch.configs.base import TPU_V5E  # noqa: E402
from repro_torch.core import hybrid  # noqa: E402
from repro_torch.core.params import map_tree, tree_leaves  # noqa: E402
from repro_torch.launch import hybrid_parallelism_demo as demo  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PAPER_TOL = dict(rtol=1e-5, atol=1e-6)
HIST_REL = 1e-5
LM_LOSS_REL, LM_GNORM_REL = 1e-3, 1e-2
MODES = {"dp": None, "zero1-gspmd": None, "zero1": "pallas-ring"}
LR = {"cd-dnn": 5e-2, "vgg-a": 5e-3}


def _spec(arch, parallel, model_ways, **kw):
    """The port's RunSpec of a reference case: members_per_device takes the
    reference's data extent on 4 devices."""
    comm = MODES.get(parallel)
    base = dict(arch=arch, smoke=True, steps=2, batch=8,
                lr=LR.get(arch, 5e-3), schedule="constant", log_every=1,
                seq=32)
    base.update(kw)
    return RunSpec(parallel=parallel,
                   comm=None if comm is None else CommConfig(backend=comm),
                   mesh=MeshSpec(members_per_device=4 // model_ways,
                                 model_ways=model_ways), **base)


_COMMON = textwrap.dedent("""
    import json, sys
    import repro.jaxcompat
    import numpy as np, jax
    from repro.api import MeshSpec, RunSpec, compile_run
    from repro.comm import CommConfig
    out, meta = {}, {}
    F32_ARCHS = ("zamba2-2.7b", "xlstm-125m")
    def leaves(tree):
        return [np.asarray(x) for x in jax.tree.leaves(tree)]
    def spec(arch, parallel, model_ways, **kw):
        comm = {"zero1": CommConfig(backend="pallas-ring")}.get(parallel)
        base = dict(arch=arch, smoke=True, steps=2, batch=8,
                    lr={"cd-dnn": 5e-2, "vgg-a": 5e-3}.get(arch, 5e-3),
                    schedule="constant", log_every=1, seq=32)
        base.update(kw)
        return RunSpec(parallel=parallel, comm=comm,
                       mesh=MeshSpec(model_ways=model_ways), **base)
    import contextlib
    @contextlib.contextmanager
    def activations(f32):
        # the residual stream in f32 (tests/test_torch_families.py's)
        import jax.numpy as jnp
        import repro.models.transformer as jt
        class F32:
            bfloat16 = jnp.float32
            def __getattr__(self, name):
                return getattr(jnp, name)
        real = jt.jnp
        if f32:
            jt.jnp = F32()
        try:
            yield
        finally:
            jt.jnp = real
    def record(tag, s, placement=False):
        with activations(s.arch in F32_ARCHS):
            _record(tag, s, placement)
    def _record(tag, s, placement):
        run = compile_run(s)
        assert run.mesh.shape["model"] == s.mesh.model_ways
        for i, x in enumerate(leaves(run.params)):
            out[f"{tag}/p0/{i}"] = x
        if placement:
            meta[tag] = {
                "params": [repr(tuple(x.sharding.spec))
                           for x in jax.tree.leaves(run.params)],
                "state": [repr(tuple(x.sharding.spec))
                          for x in jax.tree.leaves(run.opt_state)]}
        hist = run.fit(log_fn=lambda *_: None)
        out[f"{tag}/loss"] = np.array([h["loss"] for h in hist])
        out[f"{tag}/gnorm"] = np.array([h["grad_norm"] for h in hist])
        for i, x in enumerate(leaves(run.params)):
            out[f"{tag}/p1/{i}"] = x
        run.close()
    def save(path):
        np.savez(path + ".npz", **out)
        json.dump(meta, open(path + ".json", "w"))
""")


class _Reference:
    """The reference's subprocesses, started together; ``get(name)`` waits
    for one and returns (arrays, meta)."""

    def __init__(self, root):
        self.root, self.procs = root, {}

    def start(self, name, body, devices=4):
        code = _COMMON + textwrap.dedent(body) + \
            f"\nsave({os.path.join(self.root, name)!r})\n"
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count="
                   f"{devices}", OMP_NUM_THREADS="1")
        log = open(os.path.join(self.root, name + ".log"), "w")
        self.procs[name] = (subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=log,
            stderr=subprocess.STDOUT), log)

    def get(self, name):
        proc, log = self.procs[name]
        rc = proc.wait(timeout=900)
        log.close()
        path = os.path.join(self.root, name)
        assert rc == 0, open(path + ".log").read()[-4000:]
        with np.load(path + ".npz") as z:
            arrays = dict(z)
        return arrays, json.load(open(path + ".json"))

    def close(self):
        for proc, log in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _leaves(arrays, tag, which):
    n = sum(k.startswith(f"{tag}/{which}/") for k in arrays)
    return [arrays[f"{tag}/{which}/{i}"] for i in range(n)]


def _tree(run, leaves):
    it = iter(leaves)
    return map_tree(lambda _: next(it), run.full_params())


def _quiet(*_):
    pass


# the port's own checkpoints, written before the reference resumes them
PORT_CKPTS = [(m, w) for m in MODES for w in (2, 1)]
RESUMES = [(m, a, b) for m in MODES for a, b in ((2, 2), (2, 1), (1, 2))]
ARCH_SPLIT = [ALL_ARCHS[i::5] for i in range(5)]
# zamba2's AdamW steps follow gradients that bf16 rounding moves by 25%
# (tests/test_torch_families.py), so both packages run it on f32
# activations, as that file's fits do; xlstm's second loss moves by 1.8e-3
# on bf16 activations (its first within 1e-4), so it too
F32_ARCHS = ("zamba2-2.7b", "xlstm-125m")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hybrid_ref"))
    ref = _Reference(root)
    ref.ckpt_root = os.path.join(root, "ckpt")
    body = ""
    for arch in ("cd-dnn", "vgg-a"):
        for mode in MODES:
            kw = ""
            if arch == "cd-dnn":
                kw = (f", ckpt_every=2, ckpt_dir="
                      f"{os.path.join(ref.ckpt_root, f'ref-{mode}-2')!r}")
            body += (f"record('{arch}/{mode}', spec('{arch}', '{mode}', 2"
                     f"{kw}), placement=True)\n")
    for mode in MODES:
        d = os.path.join(ref.ckpt_root, f"ref-{mode}-1")
        body += (f"record('cd-dnn/{mode}/1', spec('cd-dnn', '{mode}', 1, "
                 f"ckpt_every=2, ckpt_dir={d!r}))\n")
    ref.start("paper", body)
    for i, archs in enumerate(ARCH_SPLIT):
        body = "".join(f"record('{a}/{m}', spec('{a}', '{m}', 1, batch=4))\n"
                       for a in archs for m in ("dp", "zero1-gspmd"))
        ref.start(f"archs{i}", body)
    # the port writes its checkpoints, then the reference resumes them
    for mode, w in PORT_CKPTS:
        with compile_run(_spec("cd-dnn", mode, w, ckpt_every=2, ckpt_dir=(
                os.path.join(ref.ckpt_root, f"port-{mode}-{w}"))),
                device="cpu") as run:
            run.fit(log_fn=_quiet)
    body = ""
    for mode, a, b in RESUMES:
        src = os.path.join(ref.ckpt_root, f"port-{mode}-{a}")
        dst = os.path.join(ref.ckpt_root, f"jresume-{mode}-{a}-{b}")
        shutil.copytree(src, dst)
        body += (f"record('{mode}/{a}/{b}', spec('cd-dnn', '{mode}', {b}, "
                 f"steps=4, ckpt_every=2, ckpt_dir={dst!r}))\n")
    ref.start("resume", body)
    yield ref
    ref.close()


# ---------------------------------------------------------------------------
# metadata: the planner and the demo's §3.3 numbers, exact
# ---------------------------------------------------------------------------
PLAN_MESHES = [((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")),
               ((2, 2), ("data", "model"))]


@pytest.mark.parametrize("mesh", range(len(PLAN_MESHES)))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_hybrid_plan_is_the_reference(reference, arch, shape, mesh):
    dims, axes = PLAN_MESHES[mesh]
    tm = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))
    got = hybrid.plan(get_config(arch), INPUT_SHAPES[shape], tm, TPU_V5E)
    want = jhybrid.plan(jget_config(arch), J_INPUT_SHAPES[shape],
                        AbstractMesh(dims, axes), J_TPU_V5E)
    for f in ("arch", "shape", "G", "model_ways", "G_opt_head", "G_opt_ff",
              "notes"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.rules.rules == want.rules.rules
    assert hybrid.mesh_groups(tm) == jhybrid.mesh_groups(
        AbstractMesh(dims, axes))


def test_input_shapes_are_the_reference():
    assert {k: vars(v) for k, v in INPUT_SHAPES.items()} \
        == {k: vars(v) for k, v in J_INPUT_SHAPES.items()}


def test_demo_prints_the_references_group_counts():
    cfg = jget_config("cd-dnn")
    from repro.configs.base import ConvLayerSpec as JLayer
    dims = [(cfg.input_dim, cfg.hidden_dim)] \
        + [(cfg.hidden_dim, cfg.hidden_dim)] * (cfg.num_hidden - 1) \
        + [(cfg.hidden_dim, cfg.output_dim)]
    want = [f"  layer {i}: {fin:5d}->{fout:5d}  "
            f"G*={jbalance.optimal_group_count(8, 32, fout)}  "
            f"model-parallel preferred: "
            f"{jbalance.model_parallel_preferred(JLayer('fc', ifm=fin, ofm=fout, kernel=1, out_hw=1), in_hw=1, minibatch=32)}"
            for i, (fin, fout) in enumerate(dims)]
    assert demo.group_counts(get_config("cd-dnn")) == want


def test_demo_trains_the_hybrid_as_serial_sgd(capsys):
    delta = demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "{'data': 4, 'model': 2}" in out
    assert "identity verified" in out and delta < 1e-6


# ---------------------------------------------------------------------------
# the gloo process mesh against the local mesh, 4 ranks
# ---------------------------------------------------------------------------
_GLOO_WORKER = textwrap.dedent("""
    import sys, torch
    import torch.distributed as dist
    rank, world, init, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    from repro_torch.api import MeshSpec, RunSpec, compile_run
    from repro_torch.comm import CommConfig
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.paper_cnn_training import use_kernel
    q = lambda *_: None
    for arch, lr in (("cd-dnn", 5e-2), ("vgg-a", 5e-3)):
        base = RunSpec(arch=arch, smoke=True, steps=2, batch=8, lr=lr,
                       schedule="constant", log_every=1)
        for par, comm in (("dp", None), ("zero1-gspmd", None),
                          ("zero1", CommConfig(backend="pallas-ring"))):
            mesh = make_process_mesh(model_ways=2, device="cpu")
            assert mesh.shape == {"data": 2, "model": 2}
            assert mesh.batch_shard == (rank // 2, 2)
            s = base.replace(parallel=par, comm=comm)
            run = use_kernel(compile_run(s, device="cpu", mesh=mesh))
            hist = run.fit(log_fn=q)
            full = run.full_params()
            local = use_kernel(compile_run(s.replace(
                mesh=MeshSpec(members_per_device=2, model_ways=2)),
                device="cpu"))
            lhist = local.fit(log_fn=q)
            for k, v in local.full_params().items():
                torch.testing.assert_close(full[k], v, rtol=1e-6, atol=1e-6)
            for h, l in zip(hist, lhist):
                assert abs(h["loss"] - l["loss"]) <= 1e-6 * l["loss"], (
                    arch, par, hist, lhist)
                assert abs(h["grad_norm"] - l["grad_norm"]) \\
                    <= 1e-5 * l["grad_norm"], (arch, par, hist, lhist)
            print("OK", rank, arch, par, flush=True)
    dist.barrier()
""")


def test_process_mesh_matches_the_local_mesh(reference, tmp_path):
    run_ranks(_GLOO_WORKER, 4, tmp_path, SRC)
    for r in range(4):
        assert (tmp_path / f"rank{r}.log").read_text().count(f"OK {r}") == 6


# ---------------------------------------------------------------------------
# compile_run against the reference
# ---------------------------------------------------------------------------
def _port_fit(spec, p0):
    with compile_run(spec, device="cpu") as run:
        run.load_params(_tree(run, p0))
        hist = run.fit(log_fn=_quiet)
        return run, hist, tree_leaves(run.full_params())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["cd-dnn", "vgg-a"])
def test_hybrid_compile_run_matches_the_reference(reference, arch, mode):
    arrays, meta = reference.get("paper")
    tag = f"{arch}/{mode}"
    run, hist, final = _port_fit(_spec(arch, mode, 2),
                                 _leaves(arrays, tag, "p0"))
    assert run.mesh.shape == {"data": 2, "model": 2}
    np.testing.assert_allclose([h["loss"] for h in hist],
                               arrays[f"{tag}/loss"], rtol=HIST_REL)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               arrays[f"{tag}/gnorm"], rtol=HIST_REL)
    for g, w in zip(final, _leaves(arrays, tag, "p1")):
        np.testing.assert_allclose(g.detach().numpy(), w, **PAPER_TOL)
    # the reference's GSPMD placement, leaf for leaf: params by the rules,
    # the zero1-gspmd state by zero1_state_shardings
    specs = tree_leaves(run.family.param_specs(run.cfg))
    assert [repr(run.ctx.spec(s)) for s in specs] == meta[tag]["params"]
    if mode == "zero1-gspmd":
        # momentum SGD: one state field over the param tree
        assert [repr(s) for s in run.dist_update.strip] == meta[tag]["state"]
    if arch == "cd-dnn":
        assert meta[tag]["params"][:2] == ["('model',)", "(None, 'model')"]


@pytest.mark.parametrize("mode", ["dp", "zero1-gspmd"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_gspmd_modes_match_the_reference_for_every_arch(reference, arch,
                                                        mode, monkeypatch):
    part = next(i for i, a in enumerate(ARCH_SPLIT) if arch in a)
    arrays, _ = reference.get(f"archs{part}")
    tag = f"{arch}/{mode}"
    if arch in F32_ARCHS:
        from repro_torch.models import transformer
        monkeypatch.setattr(transformer, "ACTIVATION_DTYPE", torch.float32)
    run, hist, final = _port_fit(_spec(arch, mode, 1, batch=4),
                                 _leaves(arrays, tag, "p0"))
    assert run.mesh.shape == {"data": 4, "model": 1}
    lm = arch not in LR
    loss_rel, gnorm_rel = (LM_LOSS_REL, LM_GNORM_REL) if lm \
        else (HIST_REL, HIST_REL)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               arrays[f"{tag}/loss"], rtol=loss_rel)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               arrays[f"{tag}/gnorm"], rtol=gnorm_rel)
    if not lm:
        for g, w in zip(final, _leaves(arrays, tag, "p1")):
            np.testing.assert_allclose(g.detach().numpy(), w, **PAPER_TOL)


# ---------------------------------------------------------------------------
# checkpoints across packages and model ways
# ---------------------------------------------------------------------------
def _uninterrupted(mode, p0=None):
    """The port's cd-dnn run of 4 steps at model_ways 2, from ``p0`` (the
    reference's initial leaves) or the port's own seed."""
    with compile_run(_spec("cd-dnn", mode, 2, steps=4), device="cpu") as run:
        if p0 is not None:
            run.load_params(_tree(run, p0))
        run.fit(log_fn=_quiet)
        return [x.detach().numpy() for x in tree_leaves(run.full_params())]


@pytest.mark.parametrize("mode", list(MODES))
def test_checkpoint_files_are_the_reference(reference, mode):
    reference.get("paper")
    files = {}
    for who in ("ref", "port"):
        d = os.path.join(reference.ckpt_root, f"{who}-{mode}-2")
        with np.load(os.path.join(d, "ckpt_00000002.npz")) as z:
            files[who] = {k: z[k].shape for k in z.files}
        man = ckpt.read_manifest(d, 2)
        files[who + "_meta"] = man["meta"]
    assert files["port"] == files["ref"]
    assert files["port_meta"] == files["ref_meta"]


@pytest.mark.parametrize("a,b", [(2, 2), (2, 1), (1, 2)])
@pytest.mark.parametrize("mode", list(MODES))
def test_port_resumes_reference_checkpoints_across_model_ways(reference,
                                                              mode, a, b,
                                                              tmp_path):
    arrays, _ = reference.get("paper")
    src = os.path.join(reference.ckpt_root, f"ref-{mode}-{a}")
    shutil.copytree(src, tmp_path / "c")
    with compile_run(_spec("cd-dnn", mode, b, steps=4, ckpt_every=2,
                           ckpt_dir=str(tmp_path / "c")),
                     device="cpu") as run:
        hist = run.fit(log_fn=_quiet)
        assert [h["step"] for h in hist] == [3, 4]
        got = [x.detach().numpy() for x in tree_leaves(run.full_params())]
    want = _uninterrupted(mode, _leaves(arrays, f"cd-dnn/{mode}", "p0"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **PAPER_TOL)


@pytest.mark.parametrize("a,b", [(2, 2), (2, 1), (1, 2)])
@pytest.mark.parametrize("mode", list(MODES))
def test_reference_resumes_port_checkpoints_across_model_ways(reference,
                                                              mode, a, b):
    arrays, _ = reference.get("resume")
    got = _leaves(arrays, f"{mode}/{a}/{b}", "p1")
    want = _uninterrupted(mode)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **PAPER_TOL)
