"""The port's CD-DNN slice against the JAX package, on the CPU: config,
param specs, frame stream, model, the serial and zero1 ``compile_run``
histories, and the bucket plan at full width.

Params are the reference's (``jax.random`` init), carried over as numpy
with ``interop.params_from_numpy``; batches come bitwise from both packages'
seeded ``asr_frame_stream``.  The reference's zero1 run needs G = 4
devices: one subprocess with ``--xla_force_host_platform_device_count=4``
(as ``tests/test_torch_dist.py`` runs it) computes it once for this module.

Tolerances:
- logits, loss and gradients, 1e-5 of the largest magnitude compared: f32
  layers of sums of at most 440 products (2048 at full width), taken in
  different orders by XLA and PyTorch, through sigmoids;
- the ``compile_run`` loss and grad-norm history, 1e-5 per step, relative
  (``tests/test_torch_train.py``'s bound), serial and zero1;
- the zero1 run against the port's own serial run, rtol 1e-4, atol 1e-6
  (``tests/test_torch_dist.py``'s);
- the frame stream, the param specs and the bucket plan: exact.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import compile_run as jcompile_run  # noqa: E402
from repro.comm import bucketer as jbucketer  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.configs.base import DNNConfig as JDNNConfig  # noqa: E402
from repro.data.pipeline import asr_frame_stream as jasr_stream  # noqa: E402
from repro.models import dnn as jdnn  # noqa: E402
from repro.optim.sgd import SgdState as JSgdState  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, adapter_for  # noqa: E402
from repro_torch.api import compile_run  # noqa: E402
from repro_torch.comm import CommConfig, plan_buckets  # noqa: E402
from repro_torch.configs import DNNConfig, get_config  # noqa: E402
from repro_torch.configs import smoke_variant  # noqa: E402
from repro_torch.core.params import map_tree  # noqa: E402
from repro_torch.data.pipeline import asr_frame_stream  # noqa: E402
from repro_torch.interop import opt_state_from_numpy  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import blocked_matmul as kmm  # noqa: E402
from repro_torch.launch.paper_cnn_training import use_kernel  # noqa: E402
from repro_torch.models import dnn  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-5
SMOKE = dict(arch="cd-dnn", smoke=True, steps=4, batch=8, lr=5e-2,
             schedule="constant", log_every=1)
ZERO1 = dict(parallel="zero1",
             comm=CommConfig(bucket_bytes=1 << 12, backend="pallas-ring"))
# full input and output widths, narrow hidden layers
WIDE = dict(name="cd-dnn-wide", source="test", input_dim=440, hidden_dim=64,
            num_hidden=2, output_dim=9304)


def _quiet(*_):
    pass


def _close(got, want, rel=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def test_config_and_smoke_equal_the_reference():
    cfg, jcfg = get_config("cd-dnn"), jget_config("cd-dnn")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(smoke_variant(cfg)) \
        == dataclasses.asdict(jsmoke(jcfg))
    assert adapter_for(cfg).family == "dnn"
    assert adapter_for(cfg).default_optimizer == "sgd"


@pytest.mark.parametrize("smoke", [False, True])
def test_param_specs_equal_the_reference(smoke):
    cfg, jcfg = get_config("cd-dnn"), jget_config("cd-dnn")
    if smoke:
        cfg, jcfg = smoke_variant(cfg), jsmoke(jcfg)
    specs, jspecs = dnn.param_specs(cfg), jdnn.param_specs(jcfg)
    assert list(specs) == list(jspecs)
    # sorted key order (every tree walk's, and the bucket plan's) is
    # layer-major: each bias beside its weight, layers in forward order
    layers = [int(k[2:4]) for k in sorted(specs)]
    assert layers == sorted(layers)
    assert {k: (s.shape, s.axes, s.init) for k, s in specs.items()} \
        == {k: (s.shape, s.axes, s.init) for k, s in jspecs.items()}
    if not smoke:
        assert sum(int(np.prod(s.shape)) for s in specs.values()) \
            == 45_145_176


def test_init_params_distributions():
    params = dnn.init_params(smoke_variant(get_config("cd-dnn")), seed=1,
                             device="cpu")
    for k, p in params.items():
        if k.endswith("_b"):
            assert not p.any()
        else:   # the reference's fan-in: shape[0]
            assert abs(p.std().item() * np.sqrt(p.shape[0]) - 1) < 0.2


@pytest.mark.parametrize("input_dim,senones,batch", [(40, 32, 8),
                                                     (440, 9304, 64)])
def test_asr_frame_stream_is_bitwise_the_reference(input_dim, senones,
                                                   batch):
    ours = asr_frame_stream(input_dim, senones, batch, seed=5)
    ref = jasr_stream(input_dim, senones, batch, seed=5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys() == {"frames", "senones"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _model_case(kind, batch=8, seed=0):
    if kind == "smoke":
        jcfg = jsmoke(jget_config("cd-dnn"))
        cfg = smoke_variant(get_config("cd-dnn"))
    else:
        jcfg, cfg = JDNNConfig(**WIDE), DNNConfig(**WIDE)
    jparams = jdnn.init_params(jcfg, jax.random.PRNGKey(seed))
    nparams = jax.tree.map(np.asarray, jparams)
    b = next(jasr_stream(jcfg.input_dim, jcfg.output_dim, batch, seed))
    return jcfg, cfg, jparams, nparams, b


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", ["smoke", "wide"])
def test_forward_loss_and_grads_match_reference(kind, use_kernel):
    jcfg, cfg, jparams, nparams, b = _model_case(kind, seed=3)
    jb = jax.tree.map(jnp.asarray, b)
    jlogits = jdnn.forward(jparams, jcfg, jb["frames"])
    jloss, jgrads = jax.value_and_grad(jdnn.loss_fn)(jparams, jcfg, jb)
    params = map_tree(lambda t: t.requires_grad_(),
                      params_from_numpy(nparams, "cpu"))
    tb = {k: torch.tensor(v) for k, v in b.items()}
    logits = dnn.forward(params, cfg, tb["frames"], use_kernel=use_kernel)
    assert logits.shape == (8, cfg.output_dim)
    _close(logits.detach().numpy(), jlogits)
    loss = dnn.loss_fn(params, cfg, tb, use_kernel=use_kernel)
    keys = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    _close(loss.item(), float(jloss))
    for k, g in zip(keys, grads):
        _close(g.numpy(), jgrads[k])


def test_kernel_route_goes_through_the_gemm_wrapper(monkeypatch):
    """On CPU tensors the wrapper computes its plain version: one call per
    layer of the forward, none on the plain route."""
    calls = []
    plain = kmm.blocked_matmul_plain
    monkeypatch.setattr(kmm, "blocked_matmul_plain",
                        lambda a, b, **kw: calls.append(a.shape)
                        or plain(a, b, **kw))
    run = compile_run(RunSpec(**SMOKE), device="cpu")
    batch = next(iter(run.data))
    run.close()
    run.loss_fn(run.params, batch)
    assert calls == []
    use_kernel(run).loss_fn(run.params, batch)
    assert len(calls) == run.cfg.num_hidden + 1
    run.step(batch)
    assert len(calls) == 2 * (run.cfg.num_hidden + 1)


def _jax_fit():
    run = jcompile_run(JRunSpec(**SMOKE))
    nparams = jax.tree.map(np.asarray, run.params)   # before fit donates
    hist = run.fit(log_fn=_quiet)
    run.close()
    return nparams, hist


@pytest.fixture(scope="module")
def serial_reference():
    return _jax_fit()


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_fit_history_matches_reference(serial_reference, kernel):
    nparams, want = serial_reference
    run = compile_run(RunSpec(**SMOKE), device="cpu")
    run.params = params_from_numpy(nparams, "cpu")
    run.opt_state = run.optimizer.init(run.params)
    if kernel:
        use_kernel(run)
    with run:
        got = run.fit(log_fn=_quiet)
    assert [h["step"] for h in got] == [h["step"] for h in want] \
        == [1, 2, 3, 4]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= TOL * abs(w[k]), (g, w)


@pytest.fixture(scope="module")
def zero1_reference(tmp_path_factory):
    """The reference's zero1 compile_run of the CD-DNN smoke on 4 forced
    host devices: initial params, strip state and history."""
    out = os.path.join(str(tmp_path_factory.mktemp("ref_dnn")), "ref.npz")
    code = textwrap.dedent(f"""
        import repro.jaxcompat
        import numpy as np
        from repro.api import MeshSpec, RunSpec, compile_run
        from repro.comm import CommConfig
        spec = RunSpec(**{SMOKE!r}, parallel="zero1", mesh=MeshSpec(),
                       comm=CommConfig(bucket_bytes={1 << 12},
                                       backend="pallas-ring"))
        run = compile_run(spec)
        out = {{f"p0/{{k}}": np.asarray(v) for k, v in run.params.items()}}
        for i, s in enumerate(run.opt_state.velocity):
            out[f"s0/{{i}}"] = np.asarray(s)
        hist = run.fit(log_fn=lambda *_: None)
        run.close()
        out["loss"] = np.array([h["loss"] for h in hist])
        out["grad_norm"] = np.array([h["grad_norm"] for h in hist])
        np.savez({out!r}, **out)
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def test_compile_run_zero1_matches_reference_and_serial(zero1_reference):
    ref = zero1_reference
    p0 = {k[3:]: v for k, v in ref.items() if k.startswith("p0/")}
    s0 = [ref[f"s0/{i}"] for i in range(sum(k.startswith("s0/")
                                            for k in ref))]
    run = compile_run(RunSpec(**SMOKE, **ZERO1,
                              mesh=MeshSpec(members_per_device=4)),
                      device="cpu")
    assert run.mesh.shape == {"data": 4, "model": 1}
    assert [tuple(s.shape) for s in run.opt_state.velocity] \
        == [s.shape for s in s0]
    run.params = params_from_numpy(p0, "cpu")
    run.opt_state = opt_state_from_numpy(JSgdState(velocity=s0), "cpu")
    with use_kernel(run):
        hist = run.fit(log_fn=_quiet)
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in hist], ref[k], rtol=TOL,
                                   err_msg=k)
    serial = compile_run(RunSpec(**SMOKE), device="cpu")
    serial.params = params_from_numpy(p0, "cpu")
    serial.opt_state = serial.optimizer.init(serial.params)
    with use_kernel(serial):
        serial.fit(log_fn=_quiet)
    for k in p0:
        torch.testing.assert_close(run.params[k], serial.params[k],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_plan_buckets_at_full_width_equals_reference(G):
    """Meta tensors plan CD-DNN's 45 M params without memory."""
    meta = {k: torch.empty(s.shape, device="meta")
            for k, s in dnn.param_specs(get_config("cd-dnn")).items()}
    shapes = {k: jax.ShapeDtypeStruct(s.shape, jnp.float32)
              for k, s in jdnn.param_specs(jget_config("cd-dnn")).items()}
    for bb in (0, 1 << 16, 4 * 2 ** 20, 64 * 2 ** 20):
        got = plan_buckets(meta, G, bb)
        want = jbucketer.plan_buckets(shapes, G, bb)
        assert got.n_leaves == want.n_leaves == 16
        assert [(b.size, b.padded_size,
                 [(s.index, tuple(s.shape), s.size, s.offset, s.dtype)
                  for s in b.slots]) for b in got.buckets] \
            == [(b.size, b.padded_size,
                 [(s.index, tuple(s.shape), s.size, s.offset, s.dtype)
                  for s in b.slots]) for b in want.buckets], (G, bb)
        assert got.total_padded == want.total_padded


def test_compile_run_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_run(RunSpec(arch="cd-dnn", smoke=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_run(RunSpec(arch="cd-dnn", smoke=True, **ZERO1,
                            mesh=MeshSpec(members_per_device=4)))
