"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: either package reads the other's files and resumes the other's
runs, at the same or another world size.

The reference side runs in one subprocess for this module, on 8 forced host
devices (a run at G < 8 takes the first G of them), and hands back its
manifests and final losses:

* the manifests of the same smoke ``RunSpec`` in both packages are equal,
  leaf keys and world meta, for serial SGD, zero1 SGD at G = 4, zero1 AdamW
  on a smoke LM and top-k error feedback;
* the reference saves a zero1 run at G = 8 (``pods=2``); the port resumes
  it at G = 4 and G = 2, each within 5e-3 of the reference's uninterrupted
  run at that size (the reference's own tolerance for a resume across
  world sizes, ``tests/test_cluster.py``);
* the port saves at G = 4 and the reference resumes at G = 2, within the
  same tolerance of its uninterrupted G = 2 run;

and, in this process, on numpy-built strips:

* the reference's ``ckpt.save`` of a G = 8 strip state (flat and
  hierarchical [2, 4]) restores in the port at G = 4 and 2 bitwise equal to
  the reference's own ``replan_strip_state`` of the same file, and the
  port's file re-plans in the reference bitwise equal to the port's
  restore;
* ``replan_strip_leaf`` and ``replan_strip_state`` are bitwise the
  reference's over flat and hierarchical owner orders, shrinking and
  growing, and refuse what the reference refuses;
* an interrupted and resumed run is bitwise the uninterrupted one; the
  top-k residual resumes exactly at the same world and restarts at zero at
  another; the error cases raise what the reference raises.

The runs that resume across packages start from the reference's initial
params, so that both packages train the same trajectory: both draw the
same seeded batches, and the port's zero1 steps follow the reference's
within 1e-5 (``tests/test_torch_dist.py``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import compile_run as jcompile_run  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.checkpoint.replan import replan_strip_state as jreplan_state  # noqa: E402
from repro.checkpoint.replan import world_meta as jworld_meta  # noqa: E402
from repro.comm.bucketer import plan_buckets as jplan_buckets  # noqa: E402
from repro.optim.dist import owner_perm as jowner_perm  # noqa: E402
from repro.optim.sgd import SgdState as JSgdState  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.checkpoint import ckpt, replan  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REFERENCE_TIMEOUT_S = 300   # the reference's subprocess takes ~40 s alone
BB = 4 * 2 ** 20
CFG = smoke_variant(get_config("vgg-a"))
P0 = {k: v.numpy() for k, v in cnn.init_params(CFG, 0, "cpu").items()}
SMOKE = dict(arch="vgg-a", smoke=True, batch=8, lr=5e-3,
             schedule="constant", log_every=1)


def _quiet(*_):
    pass


def _zero1(G, pods=1, **kw):
    hier = pods > 1
    return dict(parallel="zero1",
                mesh=MeshSpec(members_per_device=G, pods=pods),
                comm=CommConfig(bucket_bytes=BB, hierarchical=hier,
                                **kw.pop("comm", {})), **kw)


def _strips(world, seed, bucket_bytes=BB):
    """A numpy strip state of ``world`` in the reference's layout: per
    bucket of the smoke VGG-A plan the payload values, zero pad, rows in
    owner order."""
    rng = np.random.default_rng(seed)
    out = []
    for b in jplan_buckets(P0, world["G"], bucket_bytes).buckets:
        flat = np.zeros(b.padded_size, np.float32)
        flat[:b.size] = rng.standard_normal(b.size)
        rows = flat.reshape(world["G"], -1)
        perm = jowner_perm(world["hierarchical"], world["axes_sizes"])
        out.append(rows if perm is None else rows[perm])
    return out


def _reference_replan(d, step, old_world, new_world, G, inner=False):
    """The reference's own re-plan of checkpoint ``step`` of ``d`` at G
    (``inner``: of a top-k state's inner strips)."""
    plan = jplan_buckets(P0, G, BB)
    tpl = JSgdState(velocity=[np.zeros((G, b.padded_size // G), np.float32)
                              for b in plan.buckets])
    tpl = {"zero1": tpl} if inner else tpl
    old = jckpt.restore_loose(d, step, "opt_state", tpl)
    return jax.tree.leaves(jreplan_state(tpl, old, plan, old_world,
                                         new_world))


SAVED = {"flat8": ([8], False), "hier2x4": ([2, 4], True)}
RESUMED = {"G4": (4, 1), "G2": (2, 1), "G4-pods2": (4, 2)}


@pytest.mark.parametrize("resumed", list(RESUMED))
@pytest.mark.parametrize("saved", list(SAVED))
def test_reference_checkpoint_restores_in_the_port(saved, resumed,
                                                   tmp_path):
    old_world = jworld_meta(*SAVED[saved], BB)
    d = str(tmp_path)
    params = {k: v + 1.0 for k, v in P0.items()}
    jckpt.save(d, 5, meta={"zero1": old_world}, params=params,
               opt_state=JSgdState(velocity=_strips(old_world, 1)))
    G, pods = RESUMED[resumed]
    run = compile_run(RunSpec(**SMOKE, steps=6, ckpt_dir=d,
                              **_zero1(G, pods)), device="cpu")
    run.restore(5)
    new_world = jworld_meta([pods, G // pods] if pods > 1 else [G],
                            pods > 1, BB)
    want = _reference_replan(d, 5, old_world, new_world, G)
    got = run.opt_state.velocity
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for k, v in params.items():
        np.testing.assert_array_equal(run.params[k].detach().numpy(), v)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    d = str(tmp_path)
    with compile_run(RunSpec(**SMOKE, steps=2, ckpt_every=2, ckpt_dir=d,
                             **_zero1(4)), device="cpu") as run:
        run.fit(log_fn=_quiet)
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 2
    saved = jckpt.read_manifest(d, 2)
    assert saved["meta"] == {"zero1": jworld_meta([4], False, BB)}
    assert saved == ckpt.read_manifest(d, 2)
    # the reference's re-plan to G = 2, against the port's own restore
    want = _reference_replan(d, 2, saved["meta"]["zero1"],
                             jworld_meta([2], False, BB), 2)
    run2 = compile_run(RunSpec(**SMOKE, steps=4, ckpt_dir=d, **_zero1(2)),
                       device="cpu")
    run2.restore(2)
    for g, w in zip(run2.opt_state.velocity, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the reference's strict restore of the params it did not write
    tpl = {k: np.zeros_like(v) for k, v in P0.items()}
    trees, _ = jckpt.restore(d, 2, params=tpl)
    for k in P0:
        np.testing.assert_array_equal(np.asarray(trees["params"][k]),
                                      run.params[k].detach().numpy())


# the same smoke RunSpec in both packages (G: members; the reference's run
# takes the first G of its devices, the port's a local mesh of G members)
KEY_CASES = {
    "serial-sgd": dict(G=1, arch="vgg-a", parallel="serial", batch=8,
                       seq=128, optimizer=None, comm=None),
    "zero1-sgd-G4": dict(G=4, arch="vgg-a", parallel="zero1", batch=8,
                         seq=128, optimizer=None, comm=None),
    "zero1-adamw-lm-G4": dict(G=4, arch="gemma2-2b", parallel="zero1",
                              batch=4, seq=32, optimizer="adamw", comm=None),
    "topk-G4": dict(G=4, arch="vgg-a", parallel="zero1", batch=8, seq=128,
                    optimizer=None, comm={"wire_format": "topk"}),
}
RESUME_TOL = 5e-3
SAVE_STEP, STEPS = 3, 6

_REFERENCE = """
import repro.jaxcompat
import json
import jax
from repro.api import MeshSpec, RunSpec, compile_run
from repro.api import assemble
from repro.comm import CommConfig

all_devices, make_host_mesh = jax.devices, assemble.make_host_mesh


def at(G):
    # compile_run's mesh over the first G devices
    def make(model_ways=1, pods=1):
        jax.devices = lambda *a, **k: all_devices(*a, **k)[:G]
        try:
            return make_host_mesh(model_ways, pods=pods)
        finally:
            jax.devices = all_devices
    assemble.make_host_mesh = make


def fit(G, ckpt_dir=None, ckpt_every=0, start_step=None, pods=1, **kw):
    at(G)
    kw = dict(dict(arch="vgg-a", smoke=True, parallel="zero1", batch=8,
                   lr=5e-3, schedule="constant", log_every=100), **kw)
    run = compile_run(RunSpec(mesh=MeshSpec(pods=pods), ckpt_dir=ckpt_dir,
                              ckpt_every=ckpt_every, **kw))
    hist = run.fit(start_step=start_step, log_fn=lambda *_: None)
    run.close()
    return hist[-1]["loss"] if hist else None


out = {{}}
for name, c in {cases!r}.items():
    comm = None if c["comm"] is None else CommConfig(**c["comm"])
    fit(c["G"], ckpt_dir={keys!r} + "/" + name, ckpt_every=1, steps=1,
        arch=c["arch"], parallel=c["parallel"], batch=c["batch"],
        seq=c["seq"], optimizer=c["optimizer"], comm=comm)
fit(8, ckpt_dir={saved8!r}, ckpt_every={save}, steps={save}, pods=2)
for G in (4, 2):
    out[f"whole{{G}}"] = fit(G, steps={steps}, start_step=0)
out["from_port"] = fit(2, ckpt_dir={port4!r}, steps={steps})
with open({out!r}, "w") as f:
    json.dump(out, f)
"""


def _reference_init():
    """The reference's initial params of the smoke VGG-A (seed 0), as
    numpy: the same on one device as on a mesh."""
    run = jcompile_run(JRunSpec(arch="vgg-a", smoke=True))
    return jax.tree.map(np.asarray, run.params)


def _fit_from(init, spec):
    """Fit ``spec`` in the port from the params ``init`` (fresh strips)."""
    with compile_run(spec, device="cpu") as run:
        run.params = params_from_numpy(init, "cpu")
        run.opt_state = run.dist_update.plan.init_fn(run.params)
        return run.fit(start_step=0, log_fn=_quiet)


def _port_spec(c, **kw):
    comm = None if c["comm"] is None else CommConfig(**c["comm"])
    mesh = MeshSpec(members_per_device=c["G"])
    return RunSpec(arch=c["arch"], smoke=True, parallel=c["parallel"],
                   batch=c["batch"], seq=c["seq"], optimizer=c["optimizer"],
                   comm=comm, mesh=mesh, lr=5e-3, schedule="constant",
                   log_every=100, **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference result of this module, from one subprocess, after
    the port's G = 4 run (from the reference's initial params) saved the
    checkpoint the reference resumes."""
    tmp = tmp_path_factory.mktemp("reference_ckpt")
    dirs = {k: str(tmp / k) for k in ("keys", "saved8", "port4")}
    _fit_from(_reference_init(), RunSpec(
        **dict(SMOKE, log_every=100), steps=SAVE_STEP, ckpt_every=SAVE_STEP,
        ckpt_dir=dirs["port4"], **_zero1(4)))
    out = str(tmp / "reference.json")
    code = _REFERENCE.format(cases=KEY_CASES, save=SAVE_STEP, steps=STEPS,
                             out=out, **dirs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True,
                          timeout=REFERENCE_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return dict(json.load(f), **dirs)


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_manifest_keys_match_the_reference(case, reference, tmp_path):
    c = KEY_CASES[case]
    d = str(tmp_path)
    with compile_run(_port_spec(c, steps=1, ckpt_every=1, ckpt_dir=d),
                     device="cpu") as run:
        run.fit(log_fn=_quiet)
    got = ckpt.read_manifest(d, 1)
    want = jckpt.read_manifest(os.path.join(reference["keys"], case), 1)
    assert got["trees"] == want["trees"]
    assert got["meta"] == want["meta"]
    if c["optimizer"] == "adamw":
        assert "opt_state:count" in want["trees"]["opt_state"]
        with np.load(os.path.join(d, "ckpt_00000001.npz")) as z:
            count = z["opt_state:count"]
        assert count.shape == () and count.dtype == np.int32


@pytest.mark.parametrize("G", [4, 2])
def test_reference_run_resumes_in_the_port_at_another_world(G, reference):
    d = reference["saved8"]
    assert jckpt.read_manifest(d, SAVE_STEP)["meta"]["zero1"] == \
        jworld_meta([2, 4], True, BB)
    lines = []
    with compile_run(RunSpec(**SMOKE, steps=STEPS, ckpt_dir=d, **_zero1(G)),
                     device="cpu") as run:
        resumed = run.fit(log_fn=lines.append)[-1]["loss"]
    assert any(f"resuming from checkpoint step {SAVE_STEP}" in x
               for x in lines), lines
    whole = reference[f"whole{G}"]
    assert abs(resumed - whole) < RESUME_TOL, (resumed, whole)


def test_port_run_resumes_in_the_reference_at_another_world(reference):
    assert ckpt.read_manifest(reference["port4"], SAVE_STEP)["meta"] == {
        "zero1": jworld_meta([4], False, BB)}
    resumed, whole = reference["from_port"], reference["whole2"]
    assert abs(resumed - whole) < RESUME_TOL, (resumed, whole)


@pytest.mark.parametrize("mode", ["serial", "zero1"])
def test_interrupted_run_is_bitwise_the_uninterrupted_one(mode, tmp_path):
    kw = _zero1(4) if mode == "zero1" else {}
    whole = compile_run(RunSpec(**SMOKE, steps=6, **kw), device="cpu")
    with whole:
        whole.fit(log_fn=_quiet)
    d = str(tmp_path)
    with compile_run(RunSpec(**SMOKE, steps=4, ckpt_every=4, ckpt_dir=d,
                             **kw), device="cpu") as first:
        first.fit(log_fn=_quiet)
    lines = []
    with compile_run(RunSpec(**SMOKE, steps=6, ckpt_every=4, ckpt_dir=d,
                             **kw), device="cpu") as resumed:
        hist = resumed.fit(log_fn=lines.append)
    assert any(f"resuming from checkpoint step 4 ({d})" in x for x in lines)
    assert [h["step"] for h in hist] == [5, 6]
    for k in whole.params:
        assert torch.equal(resumed.params[k], whole.params[k]), k
    for a, b in zip(ckpt.leaves_with_paths(resumed.opt_state),
                    ckpt.leaves_with_paths(whole.opt_state)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


def test_restore_errors_match_the_reference(tmp_path):
    d = str(tmp_path)
    run = compile_run(RunSpec(**SMOKE, steps=2, ckpt_dir=d, **_zero1(2)),
                      device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint at"):
        run.restore(3)
    # a leaf the tree no longer has
    ckpt.save(d, 1, params={k: v for k, v in run.params.items()
                            if k != "conv00_w"}, opt_state=run.opt_state)
    with pytest.raises(KeyError, match="conv00_w"):
        run.restore(1)
    # strips of another shape and no world meta to re-plan from
    bad = [np.zeros((7, 3), np.float32) for _ in run.opt_state.velocity]
    jckpt.save(d, 2, params=P0, opt_state=JSgdState(velocity=bad))
    with pytest.raises(ValueError, match="meta"):
        run.restore(2)
    # a checkpoint of another bucket size cannot be re-planned
    old_world = jworld_meta([8], False, BB // 2)
    jckpt.save(d, 4, meta={"zero1": old_world}, params=P0,
               opt_state=JSgdState(velocity=_strips(
                   jworld_meta([8], False, BB), 2)))
    with pytest.raises(ValueError, match="bucket_bytes"):
        run.restore(4)


def test_leaf_numpy_cannot_hold_raises(tmp_path):
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.save(str(tmp_path), 1, params={"w": torch.zeros(
            3, dtype=torch.bfloat16)})
    assert ckpt.latest_step(str(tmp_path)) is None


def test_replan_leaf_matches_the_reference():
    from repro.checkpoint.replan import replan_strip_leaf as jreplan_leaf
    payload = np.random.default_rng(3).normal(size=37).astype(np.float32)
    worlds = [([8], False), ([2, 4], True), ([4, 2], True), ([3], False),
              ([1], False)]
    for old in worlds:
        w_old = jworld_meta(*old, 4)
        assert replan.world_meta(*old, 4) == w_old
        G = w_old["G"]
        flat = np.zeros(-(-37 // G) * G, np.float32)
        flat[:37] = payload
        arr = flat.reshape(G, -1)
        perm = jowner_perm(w_old["hierarchical"], w_old["axes_sizes"])
        arr = arr if perm is None else arr[perm]
        for new in worlds:
            w_new = jworld_meta(*new, 4)
            np.testing.assert_array_equal(
                replan.replan_strip_leaf(arr, 37, w_old, w_new),
                jreplan_leaf(arr, 37, w_old, w_new))


STATE_WORLDS = [([8], False), ([2, 4], True), ([4, 2], True), ([4], False),
                ([2, 2], True), ([2], False)]


def _state_pair(opt, G, strips):
    """The port's and the reference's strip state of ``strips`` (per
    bucket), AdamW's mu and nu both holding them, its count 7."""
    from repro.optim.adamw import AdamWState as JAdamWState
    from repro_torch.optim import AdamWState, SgdState
    port = [torch.from_numpy(np.ascontiguousarray(s)) for s in strips]
    if opt == "sgd":
        return SgdState(velocity=port), JSgdState(velocity=list(strips))
    return (AdamWState(mu=port, nu=[p.clone() for p in port], count=7),
            JAdamWState(mu=list(strips), nu=list(strips),
                        count=np.asarray(7, np.int32)))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("old", range(len(STATE_WORLDS)))
def test_replan_strip_state_matches_the_reference(opt, old):
    """Seeded strips of one world re-planned to every other (flat and
    hierarchical owner orders, shrinking and growing): the port's
    ``replan_strip_state`` is bitwise the reference's."""
    from repro_torch.comm.bucketer import plan_buckets
    from repro_torch.core.params import tree_leaves
    w_old = jworld_meta(*STATE_WORLDS[old], BB)
    _, old_state = _state_pair(opt, w_old["G"], _strips(w_old, old))
    old_leaves = jax.tree.leaves(old_state)
    for new in STATE_WORLDS:
        w_new = jworld_meta(*new, BB)
        G = w_new["G"]
        tpl, jtpl = _state_pair(opt, G, [
            np.zeros((G, b.padded_size // G), np.float32)
            for b in jplan_buckets(P0, G, BB).buckets])
        got = replan.replan_strip_state(tpl, old_leaves,
                                        plan_buckets(P0, G, BB), w_old,
                                        w_new)
        want = jreplan_state(jtpl, old_leaves, jplan_buckets(P0, G, BB),
                             w_old, w_new)
        got, want = tree_leaves(got), jax.tree.leaves(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_replan_strip_state_refuses_what_the_reference_refuses():
    from repro_torch.comm.bucketer import plan_buckets
    bb = 1 << 16    # several buckets of the smoke VGG-A
    w_old, w_new = jworld_meta([4], False, bb), jworld_meta([2], False, bb)
    old = _strips(w_old, 9, bb)
    plan, jplan = plan_buckets(P0, 2, bb), jplan_buckets(P0, 2, bb)
    assert len(plan.buckets) > 2
    new = [np.zeros((2, b.padded_size // 2), np.float32)
           for b in jplan.buckets]
    cases = {
        "bucket_bytes": (new, old, jworld_meta([2], False, bb // 2)),
        "leaves": (new, old[:-1], w_new),
        "multiples": (new[:-1], old[:-1], w_new),
        "strip shape": (new, [old[0][:, :-1], *old[1:]], w_new),
        "template shape": ([new[0][:, :-1], *new[1:]], old, w_new),
    }
    for name, (tpl, leaves, world) in cases.items():
        for fn, p in ((replan.replan_strip_state, plan),
                      (jreplan_state, jplan)):
            state = JSgdState(velocity=list(tpl))
            with pytest.raises(ValueError):
                fn(state, list(leaves), p, w_old, world)


def test_topk_state_resumes_exactly_then_restarts_its_residual(tmp_path):
    """A top-k run's error-feedback residual restores exactly at the same
    world size; at another it restarts at zero while the inner strips are
    re-planned (the reference's rule), and a bare zero1 checkpoint
    restores into a top-k run the same way."""
    d = str(tmp_path)
    topk = {"wire_format": "topk"}
    with compile_run(RunSpec(**SMOKE, steps=2, ckpt_every=2, ckpt_dir=d,
                             **_zero1(4, comm=topk)), device="cpu") as run:
        run.fit(log_fn=_quiet)
    assert any(r.abs().sum() > 0 for r in run.opt_state["residual"])
    same = compile_run(RunSpec(**SMOKE, steps=4, ckpt_dir=d,
                               **_zero1(4, comm=topk)), device="cpu")
    same.restore(2)
    for a, b in zip(ckpt.leaves_with_paths(same.opt_state),
                    ckpt.leaves_with_paths(run.opt_state)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    other = compile_run(RunSpec(**SMOKE, steps=4, ckpt_dir=d,
                                **_zero1(2, comm=topk)), device="cpu")
    other.restore(2)
    assert all(r.shape == (2, r.shape[1]) and not r.any()
               for r in other.opt_state["residual"])
    want = _reference_replan(d, 2, jworld_meta([4], False, BB),
                             jworld_meta([2], False, BB), 2, inner=True)
    for g, w in zip(other.opt_state["zero1"].velocity, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # a bare zero1 checkpoint into a top-k run of the same world
    bare = str(tmp_path / "bare")
    old_world = jworld_meta([4], False, BB)
    jckpt.save(bare, 1, meta={"zero1": old_world}, params=P0,
               opt_state=JSgdState(velocity=_strips(old_world, 5)))
    into = compile_run(RunSpec(**SMOKE, steps=4, ckpt_dir=bare,
                               **_zero1(4, comm=topk)), device="cpu")
    into.restore(1)
    assert not any(r.any() for r in into.opt_state["residual"])
    for g, w in zip(into.opt_state["zero1"].velocity,
                    _strips(old_world, 5)):
        np.testing.assert_array_equal(g.numpy(), w)
