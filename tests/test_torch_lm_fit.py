"""The port's transformer LM training run against the JAX package, on the
CPU: the smoke ``compile_run`` histories of gemma2-2b and llama3-8b,
serially on both attention routes, and gemma2-2b under ``parallel="zero1"``
at G = 4 with the ring backend.

The port starts from the reference's params (and, under zero1, its strip
state), carried over as numpy; both packages draw the same batches from the
seeded ``lm_token_stream``.  The reference's zero1 run needs G = 4 devices:
one subprocess with ``--xla_force_host_platform_device_count=4`` (as
``tests/test_torch_dnn.py`` runs it) computes it once for this module.

Tolerances:
- loss, 1e-3 relative per step, and grad norm, 1e-2: bf16 activations
  round at other places in the two frameworks (``tests/test_torch_lm_train.py``
  measures the gradients' own one-ulp sensitivity at ~1e-2 relative L2);
  measured 1.1e-4 and 1.4e-3.  A step that goes astray (no update, a wrong
  learning rate or clip) moves the next loss by percents.
- the zero1 run against the port's own serial run, rtol 1e-4, atol 1e-6
  (``tests/test_torch_dist.py``'s): the ring's mean of 4 equal gradient
  rows is the gradient, and the strip AdamW is the serial arithmetic.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import compile_run as jcompile_run  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.core.params import map_tree, tree_leaves  # noqa: E402
from repro_torch.interop import opt_state_from_numpy  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.paper_cnn_training import use_kernel  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_REL, GNORM_REL = 1e-3, 1e-2
STEPS = 4


def _smoke(arch, batch=2):
    return dict(arch=arch, smoke=True, steps=STEPS, batch=batch, seq=128,
                log_every=1)


def _quiet(*_):
    pass


def _close_history(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want] \
        == list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"]), (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) \
            <= GNORM_REL * abs(w["grad_norm"]), (g, w)


_SERIAL = {}


def _serial_reference(arch):
    if arch not in _SERIAL:
        run = jcompile_run(JRunSpec(**_smoke(arch)))
        nparams = jax.tree.map(np.asarray, run.params)   # before fit donates
        hist = run.fit(log_fn=_quiet)
        run.close()
        _SERIAL[arch] = (nparams, hist)
    return _SERIAL[arch]


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "llama3-8b"])
def test_fit_history_matches_reference(arch, route):
    nparams, want = _serial_reference(arch)
    run = compile_run(RunSpec(**_smoke(arch)), device="cpu")
    run.params = params_from_numpy(nparams, "cpu")
    run.opt_state = run.optimizer.init(run.params)
    if route == "kernel":
        use_kernel(run)
    with run:
        got = run.fit(log_fn=_quiet)
    _close_history(got, want)


@pytest.fixture(scope="module")
def zero1_reference(tmp_path_factory):
    """The reference's zero1 compile_run of the gemma2-2b smoke on 4 forced
    host devices: initial param leaves, strip state and history."""
    out = os.path.join(str(tmp_path_factory.mktemp("ref_lm")), "ref.npz")
    code = textwrap.dedent(f"""
        import repro.jaxcompat
        import jax
        import numpy as np
        from repro.api import MeshSpec, RunSpec, compile_run
        from repro.comm import CommConfig
        spec = RunSpec(**{_smoke("gemma2-2b", batch=4)!r}, parallel="zero1",
                       mesh=MeshSpec(),
                       comm=CommConfig(backend="pallas-ring"))
        run = compile_run(spec)
        out = {{f"p0/{{i}}": np.asarray(v)
               for i, v in enumerate(jax.tree.leaves(run.params))}}
        for name in ("mu", "nu"):
            for i, s in enumerate(getattr(run.opt_state, name)):
                out[f"{{name}}/{{i}}"] = np.asarray(s)
        out["count"] = np.asarray(run.opt_state.count)
        hist = run.fit(log_fn=lambda *_: None)
        run.close()
        for k in ("step", "loss", "grad_norm"):
            out[k] = np.array([h[k] for h in hist])
        np.savez({out!r}, **out)
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def _strips(ref, name):
    n = sum(k.startswith(f"{name}/") for k in ref)
    return [ref[f"{name}/{i}"] for i in range(n)]


def test_compile_run_zero1_matches_reference_and_serial(zero1_reference):
    ref = zero1_reference
    p0 = _strips(ref, "p0")
    spec = RunSpec(**_smoke("gemma2-2b", batch=4), parallel="zero1",
                   comm=CommConfig(backend="pallas-ring"),
                   mesh=MeshSpec(members_per_device=4))
    run = compile_run(spec, device="cpu")
    assert run.mesh.shape == {"data": 4, "model": 1}
    assert [tuple(s.shape) for s in run.opt_state.mu] \
        == [s.shape for s in _strips(ref, "mu")]
    it = iter(p0)
    run.params = params_from_numpy(map_tree(lambda _: next(it), run.params),
                                   "cpu")
    run.opt_state = opt_state_from_numpy(AdamWState(
        _strips(ref, "mu"), _strips(ref, "nu"), ref["count"]), "cpu")
    with use_kernel(run):
        hist = run.fit(log_fn=_quiet)
    want = [{k: ref[k][i].item() for k in ("step", "loss", "grad_norm")}
            for i in range(STEPS)]
    _close_history(hist, want)

    serial = compile_run(RunSpec(**_smoke("gemma2-2b", batch=4)),
                         device="cpu")
    it = iter(p0)
    serial.params = params_from_numpy(
        map_tree(lambda _: next(it), serial.params), "cpu")
    serial.opt_state = serial.optimizer.init(serial.params)
    with use_kernel(serial):
        serial.fit(log_fn=_quiet)
    for a, b in zip(tree_leaves(run.params), tree_leaves(serial.params)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_compile_run_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_run(RunSpec(arch="gemma2-2b", smoke=True))
