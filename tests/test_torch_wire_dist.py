"""The port's compressed wire formats (``int8`` and ``topk`` with error
feedback) in the §3.4 update against the JAX package's, and the zero1
``compile_run`` under each against the reference's.

The reference runs its G = 4 members as forced host devices in one
subprocess for this module, which computes every reference case once and
hands the results back as numpy (as ``tests/test_torch_dist.py`` does).  The
port runs the same members on a local mesh and, for the gloo cases, as G CPU
processes over ``torch.distributed``.  The optimizer is momentum SGD with
momentum 0, so that its velocity state after a step is that step's reduced
mean-gradient strips, bit for bit, in both packages.

Tolerances:
- int8 strips: within one quantum of the bucket's largest scale of the
  reference's.  Both packages quantize once per message (the first send and
  the G - 1 hops), each rounding to the nearest multiple of its scale, but
  the reference runs under ``jit``, where XLA multiplies by a rounded
  reciprocal of 127 and fuses ``q * s + chunk`` into one multiply-add
  (``tests/test_torch_ring_wire.py``), so a value near a rounding boundary
  may go to the neighbouring quantum: at most one quantum of that message's
  scale per quantization, G of them in all, and the mean divides by G.  A
  scale is at most ``G * max|g| / 127`` (every member's partial is the same
  gradient), so the bound is ``G * max|g| / 127`` per bucket.  Measured
  here: at most 1.2e-7, a scale one ulp apart, no quantum moved;
- top-k: the strips and the carried residual bitwise (selection, scatter
  and the ring's adds are exact and in the same order; the mean divides by
  G = 4 or 2, exact either way);
- params: within ``lr`` times the strips' bound of the reference's, plus
  rtol 1e-6 (the update's ``p - lr * v``, which XLA may fuse);
- the ``compile_run`` loss history within 1e-5 relative per step (f32 layers
  in another summation order, as ``tests/test_torch_dist.py``; measured
  here: 2.2e-7 under int8, 8e-8 under top-k);
- the gloo process mesh bitwise the local mesh (the same per-member
  arithmetic in the same order), for both backends.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _gloo_ranks import run_ranks  # noqa: E402
from repro.optim.sgd import SgdState as JSgdState  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.interop import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.optim import MomentumSGD  # noqa: E402
from repro_torch.optim.dist import (  # noqa: E402
    make_distributed_update,
    make_topk_ef_update,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FORMATS = ["int8", "topk"]
BUCKETS = [64, 1 << 20]
LR = 1e-2
RATIO = 0.25
G = 4
SMOKE = dict(arch="vgg-a", smoke=True, steps=3, batch=8, lr=5e-3,
             schedule="constant", log_every=1)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.normal(size=(3,)).astype(np.float32),
            "v": rng.normal(size=(40,)).astype(np.float32),
            "w": rng.normal(size=(6, 3)).astype(np.float32)}


PARAMS, GRADS1, GRADS2 = _tree(0), _tree(1), _tree(2)


def _case(fmt, bb, hier, backend):
    return f"{fmt}/{bb}/{'hier' if hier else 'flat'}/{backend}"


def _comm(fmt, bb, hier, backend):
    return CommConfig(bucket_bytes=bb, hierarchical=hier, backend=backend,
                      wire_format=fmt, topk_ratio=RATIO)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference result of this module from one subprocess: the update
    matrix (two steps each) and the zero1 compile_run histories."""
    tmp = tmp_path_factory.mktemp("reference_wire")
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **{f"{name}/{k}": v for name, t in
                        (("p", PARAMS), ("g1", GRADS1), ("g2", GRADS2))
                        for k, v in t.items()})
    out = os.path.join(str(tmp), "reference.npz")
    code = textwrap.dedent(f"""
        import repro.jaxcompat
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType
        from repro.api import RunSpec, compile_run
        from repro.comm import CommConfig
        from repro.optim import MomentumSGD
        from repro.optim.dist import (make_distributed_update,
                                      make_topk_ef_update)
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
        opt = MomentumSGD(momentum=0.0)
        for fmt in {FORMATS!r}:
            make = make_topk_ef_update if fmt == "topk" \\
                else make_distributed_update
            for bb in {BUCKETS!r}:
                for hier in (False, True):
                    for be in ("lax", "pallas-ring"):
                        mesh, axes = meshes[hier]
                        init_fn, upd = make(opt, mesh, data_axes=axes,
                                            comm=CommConfig(
                                                bucket_bytes=bb,
                                                hierarchical=hier,
                                                backend=be, wire_format=fmt,
                                                topk_ratio={RATIO}))
                        with jax.set_mesh(mesh):
                            s0 = init_fn(params)
                            f = jax.jit(upd)
                            p1, s1 = f(params, g1, s0, {LR}, 0)
                            p2, s2 = f(p1, g2, s1, {LR}, 1)
                        tag = (f"{{fmt}}/{{bb}}/"
                               f"{{'hier' if hier else 'flat'}}/{{be}}")
                        for name, t in (("p1", p1), ("p2", p2), ("s1", s1),
                                        ("s2", s2)):
                            for i, leaf in enumerate(jax.tree.leaves(t)):
                                out[f"{{tag}}/{{name}}/{{i}}"] = \\
                                    np.asarray(leaf)
        for fmt in {FORMATS!r}:
            spec = RunSpec(arch="vgg-a", smoke=True, steps=3, batch=8,
                           lr=5e-3, schedule="constant", log_every=1,
                           parallel="zero1",
                           comm=CommConfig(bucket_bytes=1 << 16,
                                           backend="pallas-ring",
                                           wire_format=fmt))
            run = compile_run(spec)
            for k, v in run.params.items():
                out[f"run/{{fmt}}/p0/{{k}}"] = np.asarray(v)
            hist = run.fit(log_fn=lambda *_: None)
            run.close()
            out[f"run/{{fmt}}/loss"] = np.array([h["loss"] for h in hist])
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
    return make_local_mesh(G, pods=2 if hier else 1), \
        (("pod", "data") if hier else ("data",))


def _state_parts(state):
    """(residuals, velocity strips) of either update's state, in the
    reference's leaf order (a dict's keys sorted, ``residual`` first)."""
    if isinstance(state, dict):
        return list(state["residual"]), list(state["zero1"].velocity)
    return [], list(state.velocity)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


def _strip_bound(fmt, grads):
    """The stated bound on a strip's difference: G * max|g| / 127 for int8
    (the largest gradient entry of any bucket bounds every bucket's), 0 for
    top-k."""
    if fmt == "topk":
        return 0.0
    return G * max(float(np.abs(g).max()) for g in grads.values()) / 127


def _check(fmt, params, state, reference, tag, step, grads_seen):
    bound = [_strip_bound(fmt, g) for g in grads_seen]
    res, vel = _state_parts(state)
    want = _ref_leaves(reference, f"{tag}/s{step}")
    assert len(want) == len(res) + len(vel), tag
    for got, w in zip(res, want[:len(res)]):
        np.testing.assert_array_equal(_np(got), w, err_msg=f"{tag} residual")
    for got, w in zip(vel, want[len(res):]):
        np.testing.assert_allclose(_np(got), w, rtol=0, atol=bound[-1],
                                   err_msg=f"{tag} strips s{step}")
    for got, w in zip([params[k] for k in sorted(params)],
                      _ref_leaves(reference, f"{tag}/p{step}")):
        np.testing.assert_allclose(_np(got), w, rtol=1e-6,
                                   atol=LR * sum(bound) + 1e-7,
                                   err_msg=f"{tag} params p{step}")


@pytest.mark.parametrize("backend", ["lax", "pallas-ring"])
@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("bb", BUCKETS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_update_matches_reference(reference, fmt, bb, hier, backend):
    tag = _case(fmt, bb, hier, backend)
    mesh, axes = _mesh(hier)
    make = make_topk_ef_update if fmt == "topk" else make_distributed_update
    init_fn, update_fn = make(MomentumSGD(momentum=0.0), mesh,
                              data_axes=axes,
                              comm=_comm(fmt, bb, hier, backend))
    params = params_from_numpy(PARAMS, "cpu")
    state = init_fn(params)
    seen = []
    for step, grads in enumerate((GRADS1, GRADS2)):
        seen.append(grads)
        params, state = update_fn(params, params_from_numpy(grads, "cpu"),
                                  state, LR, step)
        _check(fmt, params, state, reference, tag, step + 1, seen)


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_backends_agree_bitwise(fmt, hier):
    """On a local mesh the ring's kernels (plain versions here) and the lax
    backend's oracles run the same ring: the same params and state."""
    mesh, axes = _mesh(hier)
    make = make_topk_ef_update if fmt == "topk" else make_distributed_update
    outs = []
    for backend in ("lax", "pallas-ring"):
        init_fn, update_fn = make(MomentumSGD(momentum=0.9), mesh,
                                  data_axes=axes,
                                  comm=_comm(fmt, 64, hier, backend))
        params = params_from_numpy(PARAMS, "cpu")
        state = init_fn(params)
        for step, grads in enumerate((GRADS1, GRADS2)):
            params, state = update_fn(params, params_from_numpy(grads, "cpu"),
                                      state, LR, step)
        res, vel = _state_parts(state)
        outs.append([params[k] for k in sorted(params)] + res + vel)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
def test_reference_topk_state_carries_across_mid_training(reference, hier):
    """The reference's params and error-feedback state after one step,
    carried over by ``interop``, take the second step in the port to the
    reference's params and residual."""
    tag = _case("topk", 64, hier, "pallas-ring")
    s1 = _ref_leaves(reference, f"{tag}/s1")
    mesh, axes = _mesh(hier)
    init_fn, update_fn = make_topk_ef_update(
        MomentumSGD(momentum=0.0), mesh, data_axes=axes,
        comm=_comm("topk", 64, hier, "pallas-ring"))
    n_res = len(init_fn(params_from_numpy(PARAMS, "cpu"))["residual"])
    jstate = {"residual": tuple(s1[:n_res]),
              "zero1": JSgdState(velocity=s1[n_res:])}
    state = opt_state_from_numpy(jstate, "cpu")
    assert set(state) == {"residual", "zero1"}
    params = params_from_numpy(dict(zip(sorted(PARAMS), _ref_leaves(
        reference, f"{tag}/p1"))), "cpu")
    params, state = update_fn(params, params_from_numpy(GRADS2, "cpu"),
                              state, LR, 1)
    _check("topk", params, state, reference, tag, 2, [GRADS1, GRADS2])


def test_topk_residual_is_buffer_minus_kept():
    """One step from a zero residual: the kept entries (at least G, the
    ``topk_ratio`` largest |g| of each bucket) are zero in the residual,
    and the residual plus the kept buffer is the packed gradient."""
    from repro_torch.comm import pack_bucket, plan_buckets
    from repro_torch.core.params import tree_leaves
    mesh, axes = _mesh(False)
    init_fn, update_fn = make_topk_ef_update(
        MomentumSGD(momentum=0.0), mesh, data_axes=axes,
        comm=_comm("topk", 64, False, "pallas-ring"))
    params = params_from_numpy(PARAMS, "cpu")
    grads = params_from_numpy(GRADS1, "cpu")
    state = init_fn(params)
    assert all(r.shape[0] == G and not r.any() for r in state["residual"])
    _, state = update_fn(params, grads, state, LR, 0)
    plan = plan_buckets(params, G, 64)
    for b, r in zip(plan.buckets, state["residual"]):
        buf = pack_bucket(tree_leaves(grads), b)
        k = max(G, int(np.ceil(RATIO * b.padded_size)))
        kept = buf - r[0]
        assert int((kept != 0).sum()) == min(k, int((buf != 0).sum()))
        assert torch.equal(kept + r[0], buf)
        assert all(torch.equal(r[0], r[i]) for i in range(G))


def _quiet(*_):
    pass


@pytest.mark.parametrize("fmt", FORMATS)
def test_compile_run_wire_matches_reference(reference, fmt):
    spec = RunSpec(**SMOKE, parallel="zero1",
                   mesh=MeshSpec(members_per_device=G),
                   comm=CommConfig(bucket_bytes=1 << 16,
                                   backend="pallas-ring", wire_format=fmt))
    pre = f"run/{fmt}"
    keys = sorted(k.split("/")[-1] for k in reference
                  if k.startswith(f"{pre}/p0/"))
    run = compile_run(spec, device="cpu")
    assert isinstance(run.opt_state, dict) == (fmt == "topk")
    run.params = params_from_numpy(
        {k: reference[f"{pre}/p0/{k}"] for k in keys}, "cpu")
    with run:
        hist = run.fit(log_fn=_quiet)
    assert [h["step"] for h in hist] == [1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               reference[f"{pre}/loss"], rtol=1e-5)


@pytest.mark.parametrize("fmt", FORMATS)
def test_compile_run_wire_raises_without_a_card(fmt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_run(RunSpec(arch="vgg-a", smoke=True, parallel="zero1",
                            mesh=MeshSpec(members_per_device=G),
                            comm=CommConfig(backend="pallas-ring",
                                            wire_format=fmt)))


# ---------------------------------------------------------------------------
# the process mesh: G CPU processes over gloo against the local mesh
# ---------------------------------------------------------------------------
WORKER = """
import sys
import numpy as np, torch, torch.distributed as dist
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch.comm import CommConfig
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.optim import MomentumSGD
from repro_torch.optim.dist import make_distributed_update, make_topk_ef_update
z = np.load(tmp + "/inputs.npz")
out = {}
tree = lambda n: params_from_numpy(
    {k: z[f"{n}/{k}"] for k in ("b", "v", "w")}, "cpu")
flat = make_process_mesh()
pods = make_process_mesh(pods=2) if world == 4 else None
for fmt in ("int8", "topk"):
    make = make_topk_ef_update if fmt == "topk" else make_distributed_update
    for hier in ([False, True] if world == 4 else [False]):
        m = pods if hier else flat
        axes = ("pod", "data") if hier else ("data",)
        for be in ("lax", "pallas-ring"):
            init_fn, upd = make(
                MomentumSGD(momentum=0.9), m, data_axes=axes,
                comm=CommConfig(bucket_bytes=64, hierarchical=hier,
                                backend=be, wire_format=fmt,
                                topk_ratio=%r))
            params = tree("p")
            state = init_fn(params)
            params, state = upd(params, tree("g1"), state, 1e-2, 0)
            params, state = upd(params, tree("g2"), state, 1e-2, 1)
            tag = f"{fmt}/{'hier' if hier else 'flat'}/{be}"
            for k in sorted(params):
                out[f"{tag}/p/{k}"] = params[k].numpy()
            zero1 = state["zero1"] if fmt == "topk" else state
            for i, s in enumerate(zero1.velocity):
                out[f"{tag}/s/{i}"] = s.numpy()
            for i, r in enumerate(state["residual"] if fmt == "topk" else []):
                out[f"{tag}/r/{i}"] = r.numpy()
np.savez(f"{tmp}/rank{rank}.npz", **out)
dist.destroy_process_group()
""" % RATIO


def _gloo_run(world, tmp_path):
    np.savez(tmp_path / "inputs.npz", **{
        f"{name}/{k}": v for name, t in
        (("p", PARAMS), ("g1", GRADS1), ("g2", GRADS2)) for k, v in t.items()})
    run_ranks(WORKER, world, tmp_path, SRC)
    out = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            out.append(dict(z))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_wire_formats_match_local_mesh_bitwise(world, tmp_path):
    ranks = _gloo_run(world, tmp_path)
    for fmt in FORMATS:
        make = make_topk_ef_update if fmt == "topk" \
            else make_distributed_update
        for hier in ([False, True] if world == 4 else [False]):
            mesh, axes = (make_local_mesh(4, pods=2), ("pod", "data")) \
                if hier else (make_local_mesh(world), ("data",))
            for be in ("lax", "pallas-ring"):
                init_fn, upd = make(
                    MomentumSGD(momentum=0.9), mesh, data_axes=axes,
                    comm=CommConfig(bucket_bytes=64, hierarchical=hier,
                                    backend=be, wire_format=fmt,
                                    topk_ratio=RATIO))
                params = params_from_numpy(PARAMS, "cpu")
                state = init_fn(params)
                for step, g in enumerate((GRADS1, GRADS2)):
                    params, state = upd(params, params_from_numpy(g, "cpu"),
                                        state, LR, step)
                res, vel = _state_parts(state)
                tag = f"{fmt}/{'hier' if hier else 'flat'}/{be}"
                for r in range(world):
                    for k in params:
                        np.testing.assert_array_equal(
                            ranks[r][f"{tag}/p/{k}"], params[k].numpy(),
                            err_msg=tag)
                    for i, s in enumerate(vel):
                        np.testing.assert_array_equal(
                            ranks[r][f"{tag}/s/{i}"], s[r].numpy(),
                            err_msg=tag)
                    for i, x in enumerate(res):
                        np.testing.assert_array_equal(
                            ranks[r][f"{tag}/r/{i}"], x[r].numpy(),
                            err_msg=tag)
