"""The port's §3.4 distributed update (``repro_torch.optim.dist``) against
the JAX package's, and the zero1 ``compile_run`` against the reference's.

The reference runs its G = 4 members as forced host devices, in one
subprocess for this module (``--xla_force_host_platform_device_count=4``,
as ``tests/test_distributed.py`` does), which computes every reference case
once and hands the results back as numpy.  The port runs the same members
on a local mesh (one CPU tensor row per member) and, for the gloo cases, as
G CPU processes over ``torch.distributed``.

Tolerances: the update matrix within rtol 1e-6 (the ring adds in the
reference's order, the plain collectives in another order than XLA, and the
optimizers' f32 elementwise math is the same up to rounding); the
``compile_run`` loss and grad-norm history within 1e-5 per step (f32 layers
in another summation order, carried through three steps, as
``tests/test_torch_train.py``); zero1 against the port's own serial run at
rtol 1e-4, atol 1e-6 (``tests/test_api.py``'s bound for the reference); the
gloo ring bitwise against the local ring, the gloo plain collectives within
1e-6 of the local ones in f32 and 3e-2 in bf16 (gloo rounds each bf16 add,
the local sum once).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _gloo_ranks import run_ranks  # noqa: E402
from repro.optim.adamw import AdamWState as JAdamWState  # noqa: E402
from repro.optim.sgd import SgdState as JSgdState  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.comm import CommConfig, LaxBackend, RingBackend  # noqa: E402
from repro_torch.interop import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.optim import AdamW, MomentumSGD  # noqa: E402
from repro_torch.optim.dist import make_distributed_update  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPTS = {"sgd": lambda: MomentumSGD(momentum=0.9, weight_decay=1e-3),
        "adamw": lambda: AdamW(weight_decay=0.1)}
BUCKETS = [0, 64, 1 << 20]
LR = 1e-2
SMOKE = dict(arch="vgg-a", smoke=True, steps=3, batch=8, lr=5e-3,
             schedule="constant", log_every=1)
RUN_MESHES = {"flat": (1, False), "pods2": (2, True)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.normal(size=(3,)).astype(np.float32),
            "v": rng.normal(size=(40,)).astype(np.float32),
            "w": rng.normal(size=(6, 3)).astype(np.float32)}


PARAMS, GRADS1, GRADS2 = _tree(0), _tree(1), _tree(2)


def _case(opt, bb, hier, backend):
    return f"{opt}/{bb}/{'hier' if hier else 'flat'}/{backend}"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference result of this module: the update matrix (two steps
    each) and the zero1 compile_run histories, from one subprocess."""
    tmp = tmp_path_factory.mktemp("reference_dist")
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **{f"{name}/{k}": v for name, t in
                        (("p", PARAMS), ("g1", GRADS1), ("g2", GRADS2))
                        for k, v in t.items()})
    out = os.path.join(str(tmp), "reference.npz")
    code = textwrap.dedent(f"""
        import repro.jaxcompat
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType
        from repro.api import MeshSpec, RunSpec, compile_run
        from repro.comm import CommConfig
        from repro.optim import AdamW, MomentumSGD
        from repro.optim.dist import make_distributed_update
        z = np.load({inputs!r})
        tree = lambda n: {{k: jnp.asarray(z[f"{{n}}/{{k}}"])
                          for k in ("b", "v", "w")}}
        params, g1, g2 = tree("p"), tree("g1"), tree("g2")
        out = {{}}
        devs = jax.devices()[:4]
        meshes = {{False: (jax.make_mesh((4,), ("data",), devices=devs,
                                         axis_types=(AxisType.Auto,)),
                          ("data",)),
                  True: (jax.make_mesh((2, 2), ("pod", "data"),
                                       devices=devs,
                                       axis_types=(AxisType.Auto,) * 2),
                         ("pod", "data"))}}
        opts = {{"sgd": MomentumSGD(momentum=0.9, weight_decay=1e-3),
                "adamw": AdamW(weight_decay=0.1)}}
        for oname, opt in opts.items():
            for bb in {BUCKETS!r}:
                for hier in (False, True):
                    for be in ("lax", "pallas-ring"):
                        mesh, axes = meshes[hier]
                        init_fn, upd = make_distributed_update(
                            opt, mesh, data_axes=axes,
                            comm=CommConfig(bucket_bytes=bb,
                                            hierarchical=hier, backend=be))
                        with jax.set_mesh(mesh):
                            s0 = init_fn(params)
                            f = jax.jit(upd)
                            p1, s1 = f(params, g1, s0, {LR}, 0)
                            p2, s2 = f(p1, g2, s1, {LR}, 1)
                        tag = (f"{{oname}}/{{bb}}/"
                               f"{{'hier' if hier else 'flat'}}/{{be}}")
                        for name, t in (("p1", p1), ("p2", p2), ("s1", s1),
                                        ("s2", s2)):
                            for i, leaf in enumerate(jax.tree.leaves(t)):
                                out[f"{{tag}}/{{name}}/{{i}}"] = \\
                                    np.asarray(leaf)
        quiet = lambda *_: None
        for name, pods, hier in (("flat", 1, False), ("pods2", 2, True)):
            spec = RunSpec(arch="vgg-a", smoke=True, steps=3, batch=8,
                           lr=5e-3, schedule="constant", log_every=1,
                           parallel="zero1", mesh=MeshSpec(pods=pods),
                           comm=CommConfig(bucket_bytes=1 << 16,
                                           backend="pallas-ring",
                                           hierarchical=hier))
            run = compile_run(spec)
            for k, v in run.params.items():
                out[f"run/{{name}}/p0/{{k}}"] = np.asarray(v)
            for i, s in enumerate(run.opt_state.velocity):
                out[f"run/{{name}}/s0/{{i}}"] = np.asarray(s)
            hist = run.fit(log_fn=quiet)
            run.close()
            out[f"run/{{name}}/loss"] = np.array([h["loss"] for h in hist])
            out[f"run/{{name}}/grad_norm"] = np.array(
                [h["grad_norm"] for h in hist])
        np.savez({out!r}, **out)
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def _ref_leaves(reference, tag):
    out, i = [], 0
    while f"{tag}/{i}" in reference:
        out.append(reference[f"{tag}/{i}"])
        i += 1
    return out


def _mesh(hier):
    return make_local_mesh(4, pods=2 if hier else 1, device="cpu"), \
        (("pod", "data") if hier else ("data",))


def _state_leaves(state):
    leaves = []
    for field in state:
        leaves.extend(field if isinstance(field, list) else [field])
    return leaves


def _close(got, want, tag):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=1e-6, atol=1e-7, err_msg=tag)


@pytest.mark.parametrize("backend", ["lax", "pallas-ring"])
@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("bb", BUCKETS)
@pytest.mark.parametrize("opt", OPTS)
def test_distributed_update_matches_reference(reference, opt, bb, hier,
                                              backend):
    tag = _case(opt, bb, hier, backend)
    mesh, axes = _mesh(hier)
    init_fn, update_fn = make_distributed_update(
        OPTS[opt](), mesh, data_axes=axes,
        comm=CommConfig(bucket_bytes=bb, hierarchical=hier, backend=backend))
    params = params_from_numpy(PARAMS, "cpu")
    state = init_fn(params)
    for step, grads in enumerate((GRADS1, GRADS2)):
        params, state = update_fn(params, params_from_numpy(grads, "cpu"),
                                  state, LR, step)
        name = f"p{step + 1}"
        for got, want in zip([params[k] for k in sorted(params)],
                             _ref_leaves(reference, f"{tag}/{name}")):
            _close(got, want, f"{tag}/{name}")
        want_s = _ref_leaves(reference, f"{tag}/s{step + 1}")
        got_s = _state_leaves(state)
        assert len(got_s) == len(want_s)
        for got, want in zip(got_s, want_s):
            _close(got, want, f"{tag}/s{step + 1}")


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("opt", OPTS)
def test_reference_state_carries_across_mid_training(reference, opt, hier):
    """The reference's params and zero1 strip state after one step, carried
    over by ``interop``, take the second step in the port to the
    reference's params."""
    tag = _case(opt, 64, hier, "pallas-ring")
    s1 = _ref_leaves(reference, f"{tag}/s1")
    if opt == "sgd":
        jstate = JSgdState(velocity=s1)
    else:
        k = (len(s1) - 1) // 2
        jstate = JAdamWState(mu=s1[:k], nu=s1[k:2 * k], count=s1[-1])
    state = opt_state_from_numpy(jstate, "cpu")
    keys = sorted(PARAMS)
    params = params_from_numpy(dict(zip(keys, _ref_leaves(
        reference, f"{tag}/p1"))), "cpu")
    mesh, axes = _mesh(hier)
    _, update_fn = make_distributed_update(
        OPTS[opt](), mesh, data_axes=axes,
        comm=CommConfig(bucket_bytes=64, hierarchical=hier,
                        backend="pallas-ring"))
    params, _ = update_fn(params, params_from_numpy(GRADS2, "cpu"), state,
                          LR, 1)
    for got, want in zip([params[k] for k in keys],
                         _ref_leaves(reference, f"{tag}/p2")):
        _close(got, want, tag)


def _quiet(*_):
    pass


@pytest.mark.parametrize("mesh_name", RUN_MESHES)
def test_compile_run_zero1_matches_reference_and_serial(reference,
                                                        mesh_name):
    pods, hier = RUN_MESHES[mesh_name]
    spec = RunSpec(**SMOKE, parallel="zero1",
                   mesh=MeshSpec(members_per_device=4, pods=pods),
                   comm=CommConfig(bucket_bytes=1 << 16,
                                   backend="pallas-ring", hierarchical=hier))
    pre = f"run/{mesh_name}"
    keys = sorted(k.split("/")[-1] for k in reference
                  if k.startswith(f"{pre}/p0/"))
    p0 = {k: reference[f"{pre}/p0/{k}"] for k in keys}
    run = compile_run(spec, device="cpu")
    assert run.mesh.shape == ({"pod": 2, "data": 2, "model": 1} if hier
                              else {"data": 4, "model": 1})
    got_s0 = run.opt_state.velocity
    want_s0 = _ref_leaves(reference, f"{pre}/s0")
    assert [tuple(s.shape) for s in got_s0] == [s.shape for s in want_s0]
    run.params = params_from_numpy(p0, "cpu")
    run.opt_state = opt_state_from_numpy(JSgdState(velocity=want_s0), "cpu")
    with run:
        hist = run.fit(log_fn=_quiet)
    assert [h["step"] for h in hist] == [1, 2, 3]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in hist],
                                   reference[f"{pre}/{k}"], rtol=1e-5,
                                   err_msg=k)
    serial = compile_run(RunSpec(**SMOKE), device="cpu")
    serial.params = params_from_numpy(p0, "cpu")
    serial.opt_state = serial.optimizer.init(serial.params)
    with serial:
        serial.fit(log_fn=_quiet)
    for k in keys:
        torch.testing.assert_close(run.params[k], serial.params[k],
                                   rtol=1e-4, atol=1e-6)


# every mode is ported, with model ways on every family and mesh: model
# ways on a cluster mesh build under every mode, on an LM as on a CNN (at
# one process of 2 local devices, a local mesh of one data member split 2
# ways, the reference's make_host_mesh fallback)
CLUSTER_MW = MeshSpec(cluster=True, model_ways=2)


@pytest.mark.parametrize("kw", [
    dict(parallel="dp", mesh=CLUSTER_MW),
    dict(parallel="zero1-gspmd", mesh=CLUSTER_MW),
    dict(parallel="stale-sync", mesh=CLUSTER_MW),
    dict(parallel="gossip", mesh=CLUSTER_MW),
    dict(parallel="zero1", comm="auto", mesh=CLUSTER_MW),
    dict(parallel="zero1", mesh=CLUSTER_MW),
    dict(parallel="zero1", mesh=CLUSTER_MW, arch="vgg-a")],
    ids=["dp", "zero1-gspmd", "stale-sync", "gossip", "auto", "model_ways",
         "cluster"])
def test_unported_modes_raise_before_allocating(kw, monkeypatch):
    monkeypatch.setenv("REPRO_LOCAL_DEVICES", "2")
    kw = {"arch": "llama-100m", **kw}
    with compile_run(RunSpec(smoke=True, **kw), device="cpu") as run:
        assert run.mesh.shape == {"data": 1, "model": 2}
        assert run.ctx.model_ways == 2


@pytest.mark.parametrize("kw", [dict(members_per_device=0),
                                dict(members_per_device=3, pods=2),
                                dict(pods=0)])
def test_meshspec_rejects_bad_extents(kw):
    with pytest.raises(ValueError):
        MeshSpec(**kw)


# ---------------------------------------------------------------------------
# the process mesh: G CPU processes over gloo against the local mesh
# ---------------------------------------------------------------------------
WORKER = """
import os, sys
import numpy as np, torch, torch.distributed as dist
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch.comm import CommConfig, LaxBackend, RingBackend
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.optim import MomentumSGD
from repro_torch.optim.dist import make_distributed_update
z = np.load(tmp + "/inputs.npz")
out = {}
mesh = make_process_mesh(device="cpu")
for dt in ("f32", "bf16"):
    x = torch.tensor(z[f"x/{dt}"][rank]).to(getattr(torch, {
        "f32": "float32", "bf16": "bfloat16"}[dt]))
    for name, b in (("lax", LaxBackend()), ("ring", RingBackend())):
        s = b.part_reduce(x, mesh, "data")
        out[f"{dt}/{name}/strips"] = s.float().numpy()
        out[f"{dt}/{name}/full"] = b.part_broadcast(s, mesh, "data") \\
            .float().numpy()
tree = lambda n: params_from_numpy(
    {k: z[f"{n}/{k}"] for k in ("b", "v", "w")}, "cpu")
for hier in ([False, True] if world == 4 else [False]):
    m = make_process_mesh(pods=2, device="cpu") if hier else mesh
    axes = ("pod", "data") if hier else ("data",)
    for be in ("lax", "pallas-ring"):
        init_fn, upd = make_distributed_update(
            MomentumSGD(momentum=0.9, weight_decay=1e-3), m, data_axes=axes,
            comm=CommConfig(bucket_bytes=64, hierarchical=hier, backend=be))
        params = tree("p")
        state = init_fn(params)
        params, state = upd(params, tree("g1"), state, 1e-2, 0)
        params, state = upd(params, tree("g2"), state, 1e-2, 1)
        tag = f"{'hier' if hier else 'flat'}/{be}"
        for k in sorted(params):
            out[f"{tag}/p/{k}"] = params[k].numpy()
        for i, s in enumerate(state.velocity):
            out[f"{tag}/s/{i}"] = s.numpy()
np.savez(f"{tmp}/rank{rank}.npz", **out)
# every rank has written its results; gloo's own teardown has aborted a rank
# under load ("terminate called without an active exception") after that,
# so each rank waits for the others and exits without it
dist.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def _gloo_run(world, tmp_path, xs):
    np.savez(tmp_path / "inputs.npz", **xs, **{
        f"{name}/{k}": v for name, t in
        (("p", PARAMS), ("g1", GRADS1), ("g2", GRADS2)) for k, v in t.items()})
    run_ranks(WORKER, world, tmp_path, SRC)
    out = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            out.append(dict(z))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_process_mesh_matches_local_mesh(world, tmp_path):
    rng = np.random.default_rng(world)
    x = rng.normal(size=(world, 8 * world)).astype(np.float32)
    xs = {"x/f32": x,
          "x/bf16": torch.tensor(x).bfloat16().float().numpy()}
    ranks = _gloo_run(world, tmp_path, xs)
    local = make_local_mesh(world, device="cpu")
    for dt, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xt = torch.tensor(xs[f"x/{dt}"]).to(tdt)
        for name, b in (("lax", LaxBackend()), ("ring", RingBackend())):
            s = b.part_reduce(xt, local, "data")
            full = b.part_broadcast(s, local, "data")
            for r in range(world):
                for what, want in (("strips", s[r]), ("full", full[r])):
                    got = ranks[r][f"{dt}/{name}/{what}"]
                    want = want.float().numpy()
                    if name == "ring":
                        np.testing.assert_array_equal(got, want)
                    else:
                        tol = 1e-6 if dt == "f32" else 3e-2
                        np.testing.assert_allclose(got, want, rtol=tol,
                                                   atol=tol)
    for hier in ([False, True] if world == 4 else [False]):
        mesh, axes = (make_local_mesh(4, pods=2, device="cpu"),
                          ("pod", "data")) if hier \
            else (local, ("data",))
        for be in ("lax", "pallas-ring"):
            init_fn, upd = make_distributed_update(
                MomentumSGD(momentum=0.9, weight_decay=1e-3), mesh,
                data_axes=axes, comm=CommConfig(bucket_bytes=64,
                                                hierarchical=hier,
                                                backend=be))
            params = params_from_numpy(PARAMS, "cpu")
            state = init_fn(params)
            for step, g in enumerate((GRADS1, GRADS2)):
                params, state = upd(params, params_from_numpy(g, "cpu"),
                                    state, LR, step)
            tag = f"{'hier' if hier else 'flat'}/{be}"
            for r in range(world):
                for k in params:
                    got = ranks[r][f"{tag}/p/{k}"]
                    if be == "pallas-ring":
                        np.testing.assert_array_equal(
                            got, params[k].numpy(), err_msg=tag)
                    else:
                        np.testing.assert_allclose(
                            got, params[k].numpy(), rtol=1e-6, atol=1e-7,
                            err_msg=tag)
                for i, s in enumerate(state.velocity):
                    np.testing.assert_allclose(
                        ranks[r][f"{tag}/s/{i}"], s[r].numpy(),
                        rtol=1e-6, atol=1e-7, err_msg=tag)
