"""The port's §3.1 backprop overlap (``repro_torch.comm.overlap``, the
overlapped update and train step, ``core.balance``'s §3.1 closed forms)
against the JAX package's, and against the port's own monolithic zero1.

The reference runs its G = 4 members as forced host devices in one
subprocess for this module (as ``tests/test_torch_dist.py``), which
computes every reference case once and hands the results back as numpy.
The port runs the same members on a local mesh (one CPU tensor row per
member) and, for the gloo case, as 2 CPU processes over
``torch.distributed``.

The reference's overlapped step gives each member its shard of the batch
(``bspec = P(axis)``); the port's members each compute the full batch's
gradient (one tensor viewed G times on a local mesh), the same mean
gradient and loss up to rounding.  Tolerances:
- the overlapped step against the reference's ``make_overlapped_train_step``
  (SGD and AdamW; buckets of 8, 64 and 1 << 20 bytes; flat and ``pods=2``;
  two steps): the reference's own test's bounds
  (``tests/test_distributed.py``), loss rtol 1e-5, grad norm 1e-4, params
  rtol 1e-5 / atol 1e-6;
- ``compile_run`` with ``overlap=True`` (the VGG-A and CD-DNN smokes, 3
  steps) against the reference's: loss and grad norm within 1e-5 relative a
  step (f32 layers in another summation order, as in
  ``tests/test_torch_dist.py``);
- int8: the reference's taps and overlapped update on a replicated batch
  (the port's convention, so both rings quantize the same partials), with
  momentum-0 SGD so that the state after a step is the step's reduced
  strips: strips within ``G * max|g| / 127`` per bucket and params within
  ``lr`` times that plus rtol 1e-6 (``tests/test_torch_wire_dist.py``'s
  int8 bounds, derived there);
- against the port's monolithic zero1 on a local mesh: bitwise with
  ``grad_clip=0`` over 3 steps (the taps feed the same bytes to the same
  ring), and with clipping the grad norm and params within rtol 1e-6,
  params also within 1e-6 of each leaf's largest magnitude (the norm is
  summed over strips, not leaves, the clip scales the reduced strips, and
  a bias that updates of both signs leave near 0 keeps their rounding);
  under int8 with clipping only the losses, within 1e-4 (the clip scales
  the quantized strips there, the gradient before quantization in the
  monolithic step);
- the §3.1 closed forms and the bucket metadata: exactly equal (the same
  Python float arithmetic on the same inputs);
- the gloo process mesh (2 ranks) bitwise the local mesh, fp32 and int8.
"""
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _gloo_ranks import run_ranks  # noqa: E402
from repro.comm import bucketer as jbucketer  # noqa: E402
from repro.comm import overlap as joverlap  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import balance as jbalance  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import dnn as jdnn  # noqa: E402
from repro.optim.sgd import SgdState as JSgdState  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, adapter_for  # noqa: E402
from repro_torch.api import compile_run  # noqa: E402
from repro_torch.comm import CommConfig, overlap  # noqa: E402
from repro_torch.comm import bucket_triggers, issue_order  # noqa: E402
from repro_torch.comm.bucketer import plan_buckets  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import balance  # noqa: E402
from repro_torch.interop import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import cnn, dnn  # noqa: E402
from repro_torch.optim import AdamW, MomentumSGD  # noqa: E402
from repro_torch.optim.dist import make_overlapped_update  # noqa: E402
from repro_torch.optim.schedule import constant  # noqa: E402
from repro_torch.train import make_overlapped_train_step  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LR = 1e-2
OPTS = {"sgd": lambda: MomentumSGD(momentum=0.9, weight_decay=1e-3),
        "adamw": lambda: AdamW(weight_decay=0.1)}
STEP_BUCKETS = [8, 64, 1 << 20]
INT8_BUCKETS = [64, 1 << 20]
HIERS = {"flat": False, "pods2": True}
RUNS = {"vgg-a/flat": ("vgg-a", 1, 5e-3), "vgg-a/pods2": ("vgg-a", 2, 5e-3),
        "cd-dnn/flat": ("cd-dnn", 1, 5e-2)}
RUN_BUCKET = 1 << 12


def _toy(seed):
    rng = np.random.default_rng(seed)
    params = {"b": np.zeros((3,), np.float32),
              "v": rng.normal(size=(40,)).astype(np.float32),
              "w": rng.normal(size=(6, 3)).astype(np.float32)}
    batch = {"x": rng.normal(size=(16, 6)).astype(np.float32),
             "y": rng.normal(size=(16, 3)).astype(np.float32)}
    return params, batch


PARAMS, BATCH = _toy(0)


def toy_loss(p, b):
    """The reference test's loss, ``tests/test_distributed.py``."""
    pred = b["x"] @ p["w"] + p["b"] + torch.mean(p["v"])
    return torch.mean((pred - b["y"]) ** 2)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference result of this module, from one subprocess."""
    tmp = str(tmp_path_factory.mktemp("reference_overlap"))
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, **{f"p/{k}": v for k, v in PARAMS.items()},
             **{f"x/{k}": v for k, v in BATCH.items()})
    out = os.path.join(tmp, "reference.npz")
    code = textwrap.dedent(f"""
        import repro.jaxcompat
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType, PartitionSpec as P
        from repro.api import MeshSpec, RunSpec, compile_run
        from repro.comm import CommConfig
        from repro.comm.overlap import make_overlap_grad
        from repro.optim import AdamW, MomentumSGD
        from repro.optim.dist import make_overlapped_update
        from repro.optim.schedule import constant
        from repro.train import make_overlapped_train_step
        z = np.load({inputs!r})
        params = {{k: jnp.asarray(z[f"p/{{k}}"]) for k in ("b", "v", "w")}}
        batch = {{k: jnp.asarray(z[f"x/{{k}}"]) for k in ("x", "y")}}
        def loss(p, b):
            pred = b["x"] @ p["w"] + p["b"] + jnp.mean(p["v"])
            return jnp.mean((pred - b["y"]) ** 2)
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
        sched = constant({LR})
        out = {{}}
        def save(tag, p, s, ms):
            for k in sorted(p):
                out[f"{{tag}}/p/{{k}}"] = np.asarray(p[k])
            for i, leaf in enumerate(jax.tree.leaves(s)):
                out[f"{{tag}}/s/{{i}}"] = np.asarray(leaf)
            out[f"{{tag}}/loss"] = np.array([float(m["loss"]) for m in ms])
            out[f"{{tag}}/grad_norm"] = np.array(
                [float(m["grad_norm"]) for m in ms])
        for oname, opt in opts.items():
            for bb in {STEP_BUCKETS!r}:
                for hier in (False, True):
                    mesh, axes = meshes[hier]
                    comm = CommConfig(bucket_bytes=bb, hierarchical=hier,
                                      overlap=True)
                    init_fn, local_update = make_overlapped_update(
                        opt, mesh, data_axes=axes, comm=comm)
                    step = jax.jit(make_overlapped_train_step(
                        loss, sched, mesh, axes, comm, local_update))
                    with jax.set_mesh(mesh):
                        p, s, m1 = step(params, init_fn(params), 0, batch)
                        p, s, m2 = step(p, s, 1, batch)
                    save(f"step/{{oname}}/{{bb}}/{{hier}}", p, s, [m1, m2])
        # int8: the reference's taps and overlapped update, every member on
        # the full batch (the port's convention), momentum-0 SGD, no clip
        opt = MomentumSGD(momentum=0.0)
        for bb in {INT8_BUCKETS!r}:
            for hier in (False, True):
                mesh, axes = meshes[hier]
                axis = axes if len(axes) > 1 else axes[0]
                comm = CommConfig(bucket_bytes=bb, hierarchical=hier,
                                  overlap=True, backend="pallas-ring",
                                  wire_format="int8")
                init_fn, local_update = make_overlapped_update(
                    opt, mesh, data_axes=axes, comm=comm)
                grad = make_overlap_grad(loss, axis, comm, 4)
                def local_step(p, s, b):
                    l, strips = grad(p, b)
                    p, s = local_update(p, strips, s, {LR})
                    return p, s, jax.lax.pmean(l, axis)
                def one(p, s, b):
                    pspec = jax.tree.map(lambda _: P(), p)
                    sspec = jax.tree.map(lambda _: P(axis), s)
                    return jax.shard_map(
                        local_step, mesh=mesh,
                        in_specs=(pspec, sspec, jax.tree.map(lambda _: P(),
                                                             b)),
                        out_specs=(pspec, sspec, P()), check_vma=False)(
                            p, s, b)
                with jax.set_mesh(mesh):
                    p, s, l1 = jax.jit(one)(params, init_fn(params), batch)
                save(f"int8/{{bb}}/{{hier}}", p, s,
                     [{{"loss": l1, "grad_norm": 0.0}}])
        quiet = lambda *_: None
        for name, (arch, pods, lr) in {RUNS!r}.items():
            spec = RunSpec(arch=arch, smoke=True, steps=3, batch=8, lr=lr,
                           schedule="constant", log_every=1,
                           parallel="zero1", mesh=MeshSpec(pods=pods),
                           comm=CommConfig(bucket_bytes={RUN_BUCKET},
                                           backend="pallas-ring",
                                           hierarchical=pods > 1,
                                           overlap=True))
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


def _toy_step(opt, hier, comm, grad_clip=1.0, mesh=None):
    """(params, state, step) of the port's overlapped step on the toy
    problem."""
    if mesh is None:
        mesh, axes = _mesh(hier)
    else:
        axes = ("data",)
    init_fn, local_update = make_overlapped_update(opt, mesh, axes, comm)
    params = params_from_numpy(PARAMS, "cpu")
    step = make_overlapped_train_step(toy_loss, constant(LR), mesh, axes,
                                      comm, local_update,
                                      grad_clip=grad_clip)
    return params, init_fn(params), step


def _batch():
    return {k: torch.tensor(v) for k, v in BATCH.items()}


def _state_leaves(state):
    leaves = []
    for field in state:
        leaves.extend(field if isinstance(field, list) else [field])
    return leaves


# ---------------------------------------------------------------------------
# the bucket metadata and the §3.1 closed forms
# ---------------------------------------------------------------------------
FULL = {"vgg-a": (cnn, jcnn), "overfeat-fast": (cnn, jcnn),
        "cd-dnn": (dnn, jdnn)}


def _layer_of(key):
    return int(re.search(r"(\d+)_[wb]$", key).group(1))


@pytest.mark.parametrize("bb", [0, 1 << 16, 4 * 2 ** 20])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("arch", FULL)
def test_bucket_metadata_equals_reference(arch, G, bb):
    """``trigger_index``, ``backprop_order``, ``bucket_triggers`` (per leaf
    and with a layer map) and ``issue_order`` at full width, planned on
    meta tensors."""
    mod, jmod = FULL[arch]
    specs = mod.param_specs(get_config(arch))
    meta = {k: torch.empty(s.shape, device="meta") for k, s in specs.items()}
    shapes = {k: jax.ShapeDtypeStruct(s.shape, jnp.float32)
              for k, s in jmod.param_specs(jget_config(arch)).items()}
    got = plan_buckets(meta, G, bb)
    want = jbucketer.plan_buckets(shapes, G, bb)
    assert [b.trigger_index for b in got.buckets] \
        == [b.trigger_index for b in want.buckets]
    assert got.backprop_order == want.backprop_order
    layers = [_layer_of(k) for k in sorted(specs)]
    for leaf_layer in (None, layers):
        trig = bucket_triggers(got, leaf_layer)
        assert trig == joverlap.bucket_triggers(want, leaf_layer)
        assert issue_order(trig) == joverlap.issue_order(trig)


def _hw_pair(name):
    hw = {"h100": tbase.H100_SXM, "fdr": tbase.XEON_E5_2698V3_FDR,
          "10gbe": tbase.XEON_E5_2666V3_10GBE}[name]
    return hw, jbase.HardwareConfig(
        name=hw.name, peak_flops=hw.peak_flops, mem_bw=hw.mem_bw,
        link_bw=hw.link_bw, sw_latency=hw.sw_latency,
        cache_bytes=hw.cache_bytes)


@pytest.mark.parametrize("eff", [1.0, 0.4])
@pytest.mark.parametrize("hw", ["h100", "fdr", "10gbe"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_balance_closed_forms_equal_reference(seed, hw, eff):
    rng = np.random.default_rng(seed)
    n_layers, n_buckets = 6 + seed, 4 + seed
    comps = [float(c) for c in rng.uniform(1e9, 1e12, n_layers)]
    comms = [float(c) for c in rng.uniform(1e5, 1e8, n_layers)]
    times = [float(t) for t in rng.uniform(1e-5, 1e-2, n_buckets)]
    triggers = [int(t) for t in rng.integers(0, n_layers, n_buckets)]
    thw, jhw = _hw_pair(hw)
    tl = [balance.LayerBalance(f"l{i}", c, m)
          for i, (c, m) in enumerate(zip(comps, comms))]
    jl = [jbalance.LayerBalance(f"l{i}", c, m)
          for i, (c, m) in enumerate(zip(comps, comms))]
    assert balance.bubble_schedule(tl, thw, eff) \
        == jbalance.bubble_schedule(jl, jhw, eff)
    assert balance.scaling_efficiency(tl, thw, eff) \
        == jbalance.scaling_efficiency(jl, jhw, eff)
    assert balance.issue_order(triggers) == jbalance.issue_order(triggers)
    assert balance.bucket_bubble_schedule(times, triggers, comps, thw, eff) \
        == jbalance.bucket_bubble_schedule(times, triggers, comps, jhw, eff)
    assert balance.overlap_exposed_time(times, triggers, comps, thw, eff) \
        == jbalance.overlap_exposed_time(times, triggers, comps, jhw, eff)


@pytest.mark.parametrize("arch", FULL)
def test_exposed_comm_equals_reference(arch):
    mod, jmod = FULL[arch]
    specs = mod.param_specs(get_config(arch))
    meta = {k: torch.empty(s.shape, device="meta") for k, s in specs.items()}
    shapes = {k: jax.ShapeDtypeStruct(s.shape, jnp.float32)
              for k, s in jmod.param_specs(jget_config(arch)).items()}
    got = plan_buckets(meta, 4, 4 * 2 ** 20)
    want = jbucketer.plan_buckets(shapes, 4, 4 * 2 ** 20)
    layers = [_layer_of(k) for k in sorted(specs)]
    n_layers = max(layers) + 1
    comps = [1e10 * (1 + i) for i in range(n_layers)]
    times = [b.padded_size * 4 / tbase.H100_SXM.link_bw for b in got.buckets]
    thw, jhw = _hw_pair("h100")
    assert overlap.exposed_comm(got, times, comps, thw, layers) \
        == joverlap.exposed_comm(want, times, comps, jhw, layers)


# ---------------------------------------------------------------------------
# the overlapped step against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hier", HIERS)
@pytest.mark.parametrize("bb", STEP_BUCKETS)
@pytest.mark.parametrize("opt", OPTS)
def test_overlapped_step_matches_reference(reference, opt, bb, hier):
    tag = f"step/{opt}/{bb}/{HIERS[hier]}"
    comm = CommConfig(bucket_bytes=bb, hierarchical=HIERS[hier],
                      overlap=True)
    params, state, step = _toy_step(OPTS[opt](), HIERS[hier], comm)
    ms = []
    for i in range(2):
        params, state, m = step(params, state, i, _batch())
        ms.append(m)
    np.testing.assert_allclose([float(m["loss"]) for m in ms],
                               reference[f"{tag}/loss"], rtol=1e-5)
    np.testing.assert_allclose([float(m["grad_norm"]) for m in ms],
                               reference[f"{tag}/grad_norm"], rtol=1e-4)
    for k in sorted(params):
        np.testing.assert_allclose(params[k].numpy(),
                                   reference[f"{tag}/p/{k}"], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{tag}/{k}")
    want_s = _ref_leaves(reference, f"{tag}/s")
    got_s = _state_leaves(state)
    assert [tuple(np.shape(s)) for s in got_s] \
        == [np.shape(s) for s in want_s]


@pytest.mark.parametrize("hier", HIERS)
@pytest.mark.parametrize("bb", INT8_BUCKETS)
def test_int8_overlapped_step_matches_reference(reference, bb, hier):
    tag = f"int8/{bb}/{HIERS[hier]}"
    comm = CommConfig(bucket_bytes=bb, hierarchical=HIERS[hier],
                      overlap=True, backend="pallas-ring",
                      wire_format="int8")
    params, state, step = _toy_step(MomentumSGD(momentum=0.0), HIERS[hier],
                                    comm, grad_clip=0.0)
    params, state, m = step(params, state, 0, _batch())
    np.testing.assert_allclose(float(m["loss"]), reference[f"{tag}/loss"][0],
                               rtol=1e-5)
    # the bound: G * max|g| / 127 a bucket, from the exact mean gradient
    p0 = params_from_numpy(PARAMS, "cpu")
    keys = sorted(p0)
    leaves = [p0[k].requires_grad_() for k in keys]
    g = dict(zip(keys, torch.autograd.grad(toy_loss(p0, _batch()), leaves)))
    plan = plan_buckets(p0, 4, bb)
    bound = {}
    for b in plan.buckets:
        gmax = max(float(g[keys[s.index]].abs().max()) for s in b.slots)
        for s in b.slots:
            bound[keys[s.index]] = 4 * gmax / 127
    want_s = _ref_leaves(reference, f"{tag}/s")
    assert len(want_s) == len(state.velocity) == plan.n_collectives
    for got, want, b in zip(state.velocity, want_s, plan.buckets):
        tol = max(bound[keys[s.index]] for s in b.slots)
        assert np.max(np.abs(got.numpy() - want)) <= tol, tag
    for k in keys:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   reference[f"{tag}/p/{k}"], rtol=1e-6,
                                   atol=LR * bound[k], err_msg=f"{tag}/{k}")


def _quiet(*_):
    pass


@pytest.mark.parametrize("name", RUNS)
def test_compile_run_overlap_matches_reference(reference, name):
    arch, pods, lr = RUNS[name]
    spec = RunSpec(arch=arch, smoke=True, steps=3, batch=8, lr=lr,
                   schedule="constant", log_every=1, parallel="zero1",
                   mesh=MeshSpec(members_per_device=4, pods=pods),
                   comm=CommConfig(bucket_bytes=RUN_BUCKET,
                                   backend="pallas-ring",
                                   hierarchical=pods > 1, overlap=True))
    pre = f"run/{name}"
    p0 = {k.split("/")[-1]: v for k, v in reference.items()
          if k.startswith(f"{pre}/p0/")}
    s0 = _ref_leaves(reference, f"{pre}/s0")
    run = compile_run(spec, device="cpu")
    assert [tuple(s.shape) for s in run.opt_state.velocity] \
        == [s.shape for s in s0]
    run.params = params_from_numpy(p0, "cpu")
    run.opt_state = opt_state_from_numpy(JSgdState(velocity=s0), "cpu")
    with run:
        hist = run.fit(log_fn=_quiet)
    assert [h["step"] for h in hist] == [1, 2, 3]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in hist],
                                   reference[f"{pre}/{k}"], rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the overlapped step against the port's monolithic zero1
# ---------------------------------------------------------------------------
def _fit(arch, overlap_on, **kw):
    lr = 5e-2 if arch == "cd-dnn" else 5e-3
    spec = RunSpec(arch=arch, smoke=True, steps=3, batch=8, lr=lr,
                   schedule="constant", log_every=1, parallel="zero1",
                   grad_clip=kw.pop("grad_clip"),
                   mesh=MeshSpec(members_per_device=4,
                                 pods=2 if kw.get("hierarchical") else 1),
                   comm=CommConfig(backend="pallas-ring", overlap=overlap_on,
                                   **kw))
    with compile_run(spec, device="cpu") as run:
        hist = run.fit(log_fn=_quiet)
        return hist, run.params, run.opt_state


@pytest.mark.parametrize("hier", HIERS)
@pytest.mark.parametrize("bb", [0, 1 << 12, 4 * 2 ** 20])
@pytest.mark.parametrize("arch", ["vgg-a", "cd-dnn"])
def test_overlap_bitwise_monolithic_without_clip(arch, bb, hier):
    kw = dict(bucket_bytes=bb, hierarchical=HIERS[hier])
    h_mono, p_mono, s_mono = _fit(arch, False, grad_clip=0.0, **kw)
    h_ov, p_ov, s_ov = _fit(arch, True, grad_clip=0.0, **kw)
    assert [h["loss"] for h in h_ov] == [h["loss"] for h in h_mono]
    for k in p_mono:
        assert torch.equal(p_ov[k], p_mono[k]), k
    for a, b in zip(_state_leaves(s_ov), _state_leaves(s_mono)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ["vgg-a", "cd-dnn"])
def test_overlap_matches_monolithic_with_clip(arch, wire):
    kw = dict(bucket_bytes=1 << 12, wire_format=wire)
    h_mono, p_mono, _ = _fit(arch, False, grad_clip=1.0, **kw)
    h_ov, p_ov, _ = _fit(arch, True, grad_clip=1.0, **kw)
    if wire == "fp32":
        np.testing.assert_allclose([h["grad_norm"] for h in h_ov],
                                   [h["grad_norm"] for h in h_mono],
                                   rtol=1e-6)
        # a bias that three updates of both signs leave near 0 carries the
        # terms' rounding: 1e-6 of the leaf's largest magnitude
        for k in p_mono:
            torch.testing.assert_close(
                p_ov[k], p_mono[k], rtol=1e-6,
                atol=1e-6 * float(p_mono[k].detach().abs().max()))
    else:
        # the clip scales the quantized strips here, the gradient before
        # quantization there: no fp32 bound; the losses still agree
        np.testing.assert_allclose([h["loss"] for h in h_ov],
                                   [h["loss"] for h in h_mono], rtol=1e-4)


def test_int8_overlap_bitwise_monolithic_without_clip():
    kw = dict(bucket_bytes=1 << 12, wire_format="int8")
    _, p_mono, _ = _fit("vgg-a", False, grad_clip=0.0, **kw)
    _, p_ov, _ = _fit("vgg-a", True, grad_clip=0.0, **kw)
    for k in p_mono:
        assert torch.equal(p_ov[k], p_mono[k]), k


# ---------------------------------------------------------------------------
# when the taps fire
# ---------------------------------------------------------------------------
class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """Logs every aten op, so a tap's issue can be placed among them."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.log.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _fire_order(arch, bb, monkeypatch):
    """(plan, the buckets in the order their taps fired, for each the
    number of the backward's product ops (convolution or mm backward) run
    before it) for one overlapped step of the smoke."""
    log = []
    real_pack = overlap.pack_bucket

    def pack(leaves, bucket):
        log.append(bucket)
        return real_pack(leaves, bucket)

    monkeypatch.setattr(overlap, "pack_bucket", pack)
    spec = RunSpec(arch=arch, smoke=True, steps=1, batch=8, parallel="zero1",
                   mesh=MeshSpec(members_per_device=4),
                   comm=CommConfig(backend="pallas-ring", bucket_bytes=bb,
                                   overlap=True))
    with compile_run(spec, device="cpu") as run:
        plan = plan_buckets(run.params, 4, bb)
        batch = next(run.data)
        with _Ops(log):
            run.step(batch)
    fired, before, products = [], [], 0
    for item in log:
        if isinstance(item, str):
            products += item.startswith(("convolution_backward", "mm"))
        elif len(fired) < plan.n_collectives:
            fired.append(plan.buckets.index(item))
            before.append(products)
    return plan, fired, before


def test_taps_fire_in_backprop_order_inside_the_backward(monkeypatch):
    """Buckets of whole layers: the taps fire in ``backprop_order``, the
    last layer's bucket before any product of the backward below it."""
    plan, fired, before = _fire_order("vgg-a", 1 << 16, monkeypatch)
    assert plan.n_collectives == 3
    assert tuple(fired) == plan.backprop_order == (2, 1, 0)
    # forward: 2 convs, then fc04 and fc05; the taps of fc05 and fc04_w
    # fire before either conv's backward, conv00's bucket after both
    assert before[0] < before[1] < before[2]
    assert before[2] - before[1] >= 2


def test_per_tensor_taps_fire_bias_before_weight(monkeypatch):
    """One bucket per tensor: a layer's bias gradient leaves the add's
    backward before the product's backward gives the weight's, so the
    bias's tap fires first; otherwise the order is ``backprop_order``."""
    plan, fired, _ = _fire_order("vgg-a", 0, monkeypatch)
    order = list(plan.backprop_order)          # w, b of each layer
    swapped = [x for i in range(0, len(order), 2)
               for x in (order[i + 1], order[i])]
    assert fired == swapped


@pytest.mark.parametrize("arch", ["vgg-a", "cd-dnn"])
def test_use_kernel_keeps_the_overlapped_step(arch, monkeypatch):
    """``use_kernel`` swaps the loss and keeps the run's update path: the
    taps still fire, and the run stays bitwise the monolithic one."""
    from repro_torch.launch.paper_cnn_training import use_kernel
    fired = []
    real_pack = overlap.pack_bucket
    monkeypatch.setattr(overlap, "pack_bucket",
                        lambda leaves, b: fired.append(b) or real_pack(
                            leaves, b))
    params = {}
    for on in (False, True):
        spec = RunSpec(arch=arch, smoke=True, steps=2, batch=8,
                       schedule="constant", grad_clip=0.0, parallel="zero1",
                       mesh=MeshSpec(members_per_device=4),
                       comm=CommConfig(backend="pallas-ring",
                                       bucket_bytes=1 << 12, overlap=on))
        with use_kernel(compile_run(spec, device="cpu")) as run:
            run.fit(log_fn=_quiet)
            params[on] = run.params
            n = plan_buckets(run.params, 4, 1 << 12).n_collectives
    assert len(fired) == 2 * n
    for k in params[False]:
        assert torch.equal(params[True][k], params[False][k]), k


def test_bucket_the_loss_never_reaches_reduces_zeros():
    """A leaf the loss does not use still gets its bucket's strip, of
    zeros (the reference's missing cotangent), so its momentum-SGD update
    without weight decay leaves it as it was."""
    comm = CommConfig(bucket_bytes=0, overlap=True, backend="pallas-ring")
    params, state, step = _toy_step(MomentumSGD(momentum=0.9), False, comm)
    v0 = params["v"].clone()

    def no_v(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    mesh, axes = _mesh(False)
    _, local_update = make_overlapped_update(MomentumSGD(momentum=0.9),
                                             mesh, axes, comm)
    step = make_overlapped_train_step(no_v, constant(LR), mesh, axes, comm,
                                      local_update)
    params, state, m = step(params, state, 0, _batch())
    assert torch.equal(params["v"], v0)
    assert all(torch.isfinite(p).all() for p in params.values())
    assert float(m["grad_norm"]) > 0


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------
def test_topk_overlap_is_refused():
    with pytest.raises(ValueError, match="topk"):
        RunSpec(arch="vgg-a", parallel="zero1",
                comm=CommConfig(overlap=True, wire_format="topk"))


def test_compile_run_takes_overlap_and_a_cpu_device_only_when_asked(
        monkeypatch):
    from repro_torch import device as tdevice
    monkeypatch.setattr(tdevice.torch.cuda, "is_available", lambda: False)
    spec = RunSpec(arch="vgg-a", smoke=True, parallel="zero1",
                   mesh=MeshSpec(members_per_device=4),
                   comm=CommConfig(overlap=True))
    with pytest.raises(RuntimeError):
        compile_run(spec)
    with compile_run(spec, device="cpu") as run:
        assert run.comm.overlap and run.dist_update is not None


# ---------------------------------------------------------------------------
# the process mesh: 2 CPU processes over gloo against the local mesh
# ---------------------------------------------------------------------------
WORKER = """
import os, sys
import numpy as np, torch, torch.distributed as dist
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch.comm import CommConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import cnn
from repro_torch.optim import MomentumSGD
from repro_torch.optim.dist import make_overlapped_update
from repro_torch.optim.schedule import constant
from repro_torch.train import make_overlapped_train_step
z = np.load(tmp + "/inputs.npz")
cfg = smoke_variant(get_config("vgg-a"))
loss_fn = lambda p, b: cnn.loss_fn(p, cfg, b)
mesh = make_process_mesh(device="cpu")
out = {}
for wire in ("fp32", "int8"):
    comm = CommConfig(bucket_bytes=1 << 12, backend="pallas-ring",
                      wire_format=wire, overlap=True)
    init_fn, local_update = make_overlapped_update(
        MomentumSGD(momentum=0.9), mesh, ("data",), comm)
    step = make_overlapped_train_step(loss_fn, constant(5e-3), mesh,
                                      ("data",), comm, local_update,
                                      grad_clip=0.0)
    params = params_from_numpy({k[2:]: z[k] for k in z.files
                                if k.startswith("p/")}, "cpu")
    state = init_fn(params)
    for i in range(2):
        batch = {k: torch.tensor(z[f"b{i}/{k}"]) for k in ("images",
                                                            "labels")}
        params, state, m = step(params, state, i, batch)
        out[f"{wire}/loss{i}"] = m["loss"].numpy()
    for k in sorted(params):
        out[f"{wire}/p/{k}"] = params[k].detach().numpy()
    for j, s in enumerate(state.velocity):
        out[f"{wire}/s/{j}"] = s.numpy()
np.savez(f"{tmp}/rank{rank}.npz", **out)
dist.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def test_gloo_overlapped_step_matches_local_mesh(tmp_path):
    world = 2
    cfg = smoke_variant(get_config("vgg-a"))
    p0 = {k: v.numpy() for k, v in cnn.init_params(cfg, 0, "cpu").items()}
    stream = adapter_for(cfg).stream(cfg, 8, 0, 0)
    batches = [next(stream) for _ in range(2)]
    np.savez(tmp_path / "inputs.npz", **{f"p/{k}": v for k, v in p0.items()},
             **{f"b{i}/{k}": v for i, b in enumerate(batches)
                for k, v in b.items()})
    run_ranks(WORKER, world, tmp_path, SRC)
    # the ranks' thread count, so that the local forward and backward sum
    # in their order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _gloo_check(world, cfg, p0, batches, tmp_path)
    finally:
        torch.set_num_threads(threads)


def _gloo_check(world, cfg, p0, batches, tmp_path):
    ranks = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    for wire in ("fp32", "int8"):
        comm = CommConfig(bucket_bytes=1 << 12, backend="pallas-ring",
                          wire_format=wire, overlap=True)
        mesh = make_local_mesh(world, device="cpu")
        init_fn, local_update = make_overlapped_update(
            MomentumSGD(momentum=0.9), mesh, ("data",), comm)
        step = make_overlapped_train_step(
            lambda p, b: cnn.loss_fn(p, cfg, b), constant(5e-3), mesh,
            ("data",), comm, local_update, grad_clip=0.0)
        params = params_from_numpy(p0, "cpu")
        state = init_fn(params)
        losses = []
        for i, b in enumerate(batches):
            params, state, m = step(params, state, i,
                                    {k: torch.tensor(v)
                                     for k, v in b.items()})
            losses.append(m["loss"].numpy())
        for r in range(world):
            for i, loss in enumerate(losses):
                np.testing.assert_array_equal(ranks[r][f"{wire}/loss{i}"],
                                              loss)
            for k in params:
                np.testing.assert_array_equal(
                    ranks[r][f"{wire}/p/{k}"], params[k].detach().numpy(),
                    err_msg=f"{wire}/{k}")
            for j, s in enumerate(state.velocity):
                np.testing.assert_array_equal(ranks[r][f"{wire}/s/{j}"],
                                              s[r].numpy())
