"""The port's three examples (``launch/quickstart.py``,
``launch/train_lm_100m.py``, ``launch/serve_batched.py``) against the
reference's (``examples/``), on the CPU at cut sizes through their own
arguments or spec.

One reference subprocess, started at module setup, first writes the
reference's initial params of the two training runs (the port starts from
them, as ``tests/test_torch_lm_fit.py``'s runs do), then trains:
quickstart's spec at 3 steps, and ``examples/train_lm_100m.py`` at 2 steps
of batch 2 x seq 32 (llama-100m at full width) twice, the second run
resuming with nothing to train.  When the port's own checkpoint is written
it resumes that too, and reports the params it restored.

- quickstart and train_lm_100m: every logged loss within 1e-3 relative of
  the reference's (the LM fit tests' tolerance: bf16 activations round at
  other places); the port's second run trains nothing and leaves the
  checkpoint and ``history.csv``; the reference restores the port's
  checkpoint bitwise and trains nothing.
- serve_batched at 4 requests on smoke gemma2-2b (the reference's Server
  in this process, the port's on its params): the same scheduler ``steps``
  and ``preemptions``, and the same tokens up to the first step where the
  reference's top-2 logit margin is within twice the two packages' logit
  difference (``tests/test_torch_serve.py``'s near-tie rule).
"""
import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ServeSpec as JServeSpec  # noqa: E402
from repro.api import compile_serve as jcompile_serve  # noqa: E402
from repro.core.sharding import ShardingCtx as JCtx  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.api import RunSpec, compile_run  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.launch import quickstart, serve_batched  # noqa: E402
from repro_torch.launch import train_lm_100m  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
ROOT = os.path.join(os.path.dirname(__file__), "..")
LOSS_REL = 1e-3
LM_ARGV = ["--steps", "2", "--batch", "2", "--seq", "32"]

_REFERENCE = r"""
import dataclasses, hashlib, json, os, sys, time
import numpy as np
import repro  # noqa: F401
import jax
sys.path.insert(0, os.path.join(sys.argv[1], "examples"))
import train_lm_100m as jexample
from repro.api import RunSpec, compile_run

root, qs_spec, lm_argv = sys.argv[2], json.loads(sys.argv[3]), sys.argv[4:]
quiet = lambda *_: None
lm_dir, port_dir = os.path.join(root, "ref_lm"), os.path.join(root, "port_lm")
qs = compile_run(RunSpec(**qs_spec))
lm_spec = RunSpec(arch="llama-100m", steps=2, batch=2, seq=32, lr=6e-4,
                  weight_decay=0.1, log_every=10, ckpt_dir=port_dir,
                  ckpt_every=50)
lm = compile_run(dataclasses.replace(lm_spec, ckpt_dir=None))
init = {}
for tag, run in (("qs", qs), ("lm", lm)):
    for i, x in enumerate(jax.tree.leaves(run.params)):
        init[f"{tag}/{i}"] = np.asarray(x)
np.savez(os.path.join(root, "init.npz"), **init)
os.rename(os.path.join(root, "init.npz"), os.path.join(root, "init_ready.npz"))
lm.close()
json.dump([h["loss"] for h in qs.fit(log_fn=quiet)],
          open(os.path.join(root, "qs.json"), "w"))
qs.close()
out = {}
out["lm"] = [h["loss"] for h in jexample.main(lm_argv + ["--ckpt-dir", lm_dir])]
out["lm_again"] = jexample.main(lm_argv + ["--ckpt-dir", lm_dir])
deadline = time.time() + 900
while not os.path.exists(os.path.join(root, "port_done")):
    assert time.time() < deadline, "the port's checkpoint never came"
    time.sleep(0.5)
run = compile_run(lm_spec)
out["port_resumed"] = run.fit(log_fn=quiet)
out["port_params"] = [hashlib.sha1(np.ascontiguousarray(
    np.asarray(x)).tobytes()).hexdigest() for x in jax.tree.leaves(run.params)]
json.dump(out, open(os.path.join(root, "ref.json"), "w"))
"""


class _Reference:
    def __init__(self, root):
        self.root = root
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
                   XLA_FLAGS="--xla_force_host_platform_device_count=1")
        self.log = open(os.path.join(root, "ref.log"), "w")
        # the knobs quickstart's spec sets (the rest are both defaults)
        spec = quickstart.spec(3)
        base = RunSpec(arch=spec.arch)
        qs_spec = {f.name: getattr(spec, f.name)
                   for f in dataclasses.fields(spec)
                   if getattr(spec, f.name) != getattr(base, f.name)}
        qs_spec["arch"] = spec.arch
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, ROOT, root,
             json.dumps(qs_spec)] + LM_ARGV,
            env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self._init = self._out = None

    def _fail(self):
        self.log.flush()
        return open(os.path.join(self.root, "ref.log")).read()[-4000:]

    def wait(self, name):
        """The path of file ``name`` once the subprocess has written it."""
        path = os.path.join(self.root, name)
        while not os.path.exists(path):
            assert self.proc.poll() is None, self._fail()
            time.sleep(0.2)
        return path

    def init(self, tag):
        """The reference's initial param leaves of run ``tag``."""
        if self._init is None:
            with np.load(self.wait("init_ready.npz")) as z:
                self._init = dict(z)
        n = sum(k.startswith(tag + "/") for k in self._init)
        return [self._init[f"{tag}/{i}"] for i in range(n)]

    def out(self):
        if self._out is None:
            rc = self.proc.wait(timeout=900)
            assert rc == 0, self._fail()
            self._out = json.load(open(os.path.join(self.root, "ref.json")))
        return self._out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """Started with the module's first test (the serving one, which needs
    no subprocess), so that it trains while that test runs."""
    ref = _Reference(str(tmp_path_factory.mktemp("examples_ref")))
    yield ref
    ref.close()


def _from(params, make):
    """``make`` (``compile_run`` or ``compile_serve``) whose result starts
    from the reference's ``params`` (leaves in the tree's order)."""
    def made(*a, **kw):
        out = make(*a, **kw)
        with torch.no_grad():
            for p, x in zip(tree_leaves(out.params), params):
                p.copy_(torch.from_numpy(np.array(x)))
        return out
    return made


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------
SERVE_ARGV = ["--requests", "4", "--prompt-len", "24", "--new-tokens", "12"]


def _ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def test_serve_batched_serves_the_references_tokens(capsys, monkeypatch):
    args = serve_batched.parse_args(SERVE_ARGV + ["--device", "cpu"])
    spec = serve_batched.serve_spec(args)
    js = jcompile_serve(JServeSpec(**{
        f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
        if f.name not in ("attn_impl",)}, attn_impl="pallas"))
    monkeypatch.setattr(serve_batched, "compile_serve", _from(
        jax.tree.leaves(js.params), serve_batched.compile_serve))
    server, done = serve_batched.main(SERVE_ARGV + ["--device", "cpu"])
    assert "4 requests" in capsys.readouterr().out
    reqs = serve_batched.submit_requests(js, args)
    jdone = {r.rid: r.output for r in js.drain()}
    tdone = {r.rid: r.output for r in done}
    assert sorted(jdone) == sorted(tdone) == [0, 1, 2, 3]
    for k in ("steps", "preemptions", "completed"):
        assert server.stats[k] == js.stats[k], k
    compared = total = 0
    for rid, (prompt, new) in enumerate(reqs):
        ref, got = jdone[rid], tdone[rid]
        assert len(got) == len(ref) == new
        seq = np.concatenate([prompt, ref[:-1]])[None]
        jlog = np.asarray(jt.forward(js.params, js.cfg, JCtx(),
                                     tokens=jnp.asarray(seq))[0], np.float32)
        tlog = tt.forward(server.params, server.cfg,
                          tokens=torch.tensor(seq))[0].float().numpy()
        delta = np.abs(tlog - jlog).max()
        steps = jlog[0, len(prompt) - 1:]
        top2 = np.sort(steps, axis=-1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        tol = max(2 * delta, _ulp(jlog))
        for i in range(new):
            if got[i] != ref[i]:
                assert margins[i] <= tol, (rid, i, got.tolist(), ref.tolist())
                break
            compared += 1
        total += new
    assert compared >= 0.75 * total, (compared, total)


def _losses_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_REL * abs(w), (got, want)


def test_quickstart_spec_trains_as_the_reference(reference):
    spec = quickstart.spec(3)
    assert (spec.arch, spec.smoke, spec.batch, spec.seq) == \
        ("llama3-8b", True, 8, 64)
    with compile_run(spec, device="cpu") as run:
        with torch.no_grad():
            for p, x in zip(tree_leaves(run.params), reference.init("qs")):
                p.copy_(torch.from_numpy(x))
        hist = run.fit(log_fn=lambda *_: None)
    _losses_close([float(h["loss"]) for h in hist],
                  json.load(open(reference.wait("qs.json"))))


def test_train_lm_100m_trains_resumes_and_crosses_packages(reference,
                                                           capsys,
                                                           monkeypatch):
    d = os.path.join(reference.root, "port_lm")
    argv = LM_ARGV + ["--device", "cpu", "--ckpt-dir", d]
    with monkeypatch.context() as m:
        m.setattr(train_lm_100m, "compile_run",
                  _from(reference.init("lm"), compile_run))
        hist = train_lm_100m.main(argv)
    assert [h["step"] for h in hist] == [1, 2]
    rows = open(os.path.join(d, "history.csv")).read().splitlines()
    assert rows[0] == "step,loss" and len(rows) == 3
    assert train_lm_100m.main(argv) == []
    assert "nothing to train" in capsys.readouterr().out
    assert open(os.path.join(d, "history.csv")).read().splitlines() == rows
    ckpts = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert ckpts == ["ckpt_00000002.npz"]
    with compile_run(train_lm_100m.spec_from_args(argparse.Namespace(
            arch="llama-100m", steps=2, batch=2, seq=32, lr=6e-4,
            ckpt_dir=d)), device="cpu") as run:
        assert run.fit(log_fn=lambda *_: None) == []
        mine = [hashlib.sha1(np.ascontiguousarray(x.numpy()).tobytes())
                .hexdigest() for x in tree_leaves(run.params)]
    open(os.path.join(reference.root, "port_done"), "w").close()
    out = reference.out()
    _losses_close([float(h["loss"]) for h in hist], out["lm"])
    assert out["lm_again"] == []
    assert out["port_resumed"] == []
    assert out["port_params"] == mine
