"""Serial training of the port (``RunSpec -> compile_run -> Run.fit``)
against the JAX package, on the CPU, and the port's rejections of what it
does not run yet.

The Run parity takes the reference's initial params (``jax.random``) into
``run.params`` and re-initialises the optimizer state; both runs draw
bitwise the same batches from the seeded image stream.  Tolerance per
logged step: 1e-5 of the reference's loss and grad norm — f32 layers in
another summation order, carried through a few momentum-SGD steps.
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import compile_run as jcompile_run  # noqa: E402
from repro_torch.api import MeshSpec, PARALLEL_MODES, RunSpec, compile_run  # noqa: E402
from repro_torch.configs.base import H100_SXM  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, make_placer  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import paper_cnn_training  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

REL_TOL = 1e-5
SMOKE = dict(arch="vgg-a", smoke=True, steps=5, batch=8, lr=5e-3,
             log_every=1)


def _quiet(*_):
    pass


def _jax_fit(**kw):
    run = jcompile_run(JRunSpec(**{**SMOKE, **kw}))
    nparams = jax.tree.map(np.asarray, run.params)   # before fit donates
    hist = run.fit(log_fn=_quiet)
    run.close()
    return nparams, hist


def _torch_run(nparams=None, **kw):
    run = compile_run(RunSpec(**{**SMOKE, **kw}), device="cpu")
    if nparams is not None:
        run.params = params_from_numpy(nparams, "cpu")
        run.opt_state = run.optimizer.init(run.params)
    return run


@pytest.mark.parametrize("kw", [dict(schedule="constant"),
                                dict(schedule="warmup_cosine"),
                                dict(schedule="constant", optimizer="adamw")],
                         ids=["sgd-constant", "sgd-warmup_cosine",
                              "adamw-constant"])
def test_fit_history_matches_reference(kw):
    nparams, want = _jax_fit(**kw)
    with _torch_run(nparams, **kw) as run:
        got = run.fit(log_fn=_quiet)
    assert [h["step"] for h in got] == [h["step"] for h in want] \
        == [1, 2, 3, 4, 5]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= REL_TOL * abs(w[k]), (g, w)


def test_kernel_route_matches_plain_route_on_cpu():
    """The launcher's ``--use-kernel`` route (the kernel's plain version on
    CPU tensors, reference backward) trains like the default route."""
    args = ["--device", "cpu", "--steps", "3", "--batch", "4"]
    plain = paper_cnn_training.main(args)
    kern = paper_cnn_training.main(args + ["--use-kernel"])
    assert len(plain) == len(kern) == 2       # first and final step
    for p, k in zip(plain, kern):
        assert abs(p["loss"] - k["loss"]) <= REL_TOL * abs(p["loss"])
        assert np.isfinite(k["loss"])


class _Recorder:
    def __init__(self):
        self.spans, self.counts = [], {}

    def span(self, kind, **attrs):
        self.spans.append(kind)
        return _NullCtx()

    def count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_trainer_logs_first_every_and_final_step_and_counts():
    rec = _Recorder()
    run = compile_run(RunSpec(**{**SMOKE, "steps": 7, "log_every": 3,
                                 "batch": 2}), device="cpu", recorder=rec)
    with run:
        hist = run.fit(log_fn=_quiet)
    assert [h["step"] for h in hist] == [1, 3, 6, 7]
    assert rec.spans.count("step") == rec.spans.count("data_wait") == 7
    assert rec.spans.count("first_step") == 1
    assert rec.counts == {"steps": 7, "items_samples": 6 * 2}


def test_run_step_advances_params_in_place():
    run = _torch_run()
    batch = {k: v for k, v in next(iter(run.data)).items()}
    before = {k: p.detach().clone() for k, p in run.params.items()}
    w = run.params["conv00_w"]
    metrics = run.step(batch, step_idx=3)   # warmup_cosine: lr 0 at step 0
    assert run.params["conv00_w"] is w
    assert not torch.equal(w, before["conv00_w"])
    assert set(metrics) == {"loss", "grad_norm", "lr"}
    run.close()


def test_trainer_stops_when_the_data_runs_out():
    run = _torch_run()
    batches = [next(iter(run.data)) for _ in range(2)]
    run.close()
    lines = []
    trainer = Trainer(run.train_step, TrainerConfig(total_steps=5,
                                                    log_every=1))
    _, _, hist = trainer.fit(run.params, run.opt_state, iter(batches),
                             log_fn=lines.append)
    assert [h["step"] for h in hist] == [1, 2]
    assert "data exhausted at step 2" in lines[-1]


@pytest.mark.parametrize("kw", [dict(parallel="async"),
                                dict(optimizer="lars"),
                                dict(schedule="linear"),
                                dict(steps=0),
                                dict(comm="bogus"),
                                dict(comm="auto"),
                                dict(parallel="dp", comm="auto")])
def test_runspec_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        JRunSpec(arch="vgg-a", **kw)
    with pytest.raises(ValueError):
        RunSpec(arch="vgg-a", **kw)


def test_runspec_takes_every_reference_mode():
    from repro.api import PARALLEL_MODES as JMODES
    assert PARALLEL_MODES == JMODES
    spec = RunSpec(arch="vgg-a")
    for mode in PARALLEL_MODES:
        assert spec.replace(parallel=mode).parallel == mode
    assert RunSpec(arch="vgg-a", parallel="zero1", comm="auto").comm == "auto"


@pytest.mark.parametrize("mode", [m for m in PARALLEL_MODES if m != "serial"])
def test_compile_run_rejects_unported_modes(mode):
    # every mode is ported, with model ways on every family; model ways on
    # a cluster mesh raise (Queue A item 9d)
    with pytest.raises(NotImplementedError, match="item 9d"):
        compile_run(RunSpec(arch="llama-100m", smoke=True, parallel=mode,
                            mesh=MeshSpec(cluster=True, model_ways=2)),
                    device="cpu")


def test_unported_pieces_raise():
    with pytest.raises(ValueError, match="CommConfig"):
        RunSpec(arch="vgg-a", parallel="zero1", comm=object())
    # the token LMs have a family now; a config of no registered family
    # still raises
    with pytest.raises(TypeError, match="no family adapter"):
        compile_run(RunSpec(arch=H100_SXM), device="cpu")


@pytest.mark.parametrize("kw", [dict(ckpt_dir="ckpts"),
                                dict(ckpt_every=2, ckpt_dir="ckpts")])
def test_fit_with_checkpoints_raises(kw, tmp_path):
    """Checkpoints are ported: a fit writes one every ``ckpt_every`` steps
    (none without it), and a run whose tree does not match the checkpoint
    it would resume from raises instead of training on."""
    kw = {**kw, "ckpt_dir": str(tmp_path / kw["ckpt_dir"])}
    with _torch_run(**kw) as run:
        run.fit(log_fn=_quiet)
    saved = sorted(os.listdir(kw["ckpt_dir"])) \
        if os.path.isdir(kw["ckpt_dir"]) else []
    every = kw.get("ckpt_every", 0)
    assert saved == [f"ckpt_{s:08d}.{ext}" for s in range(every, 6, every)
                     for ext in ("json", "npz")] if every else saved == []
    if every:
        with _torch_run(**kw, optimizer="adamw") as other:
            with pytest.raises(KeyError, match="tree structure"):
                other.fit(log_fn=_quiet)


def test_compile_run_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_run(RunSpec(arch="vgg-a", smoke=True))


def test_prefetcher_ends_finite_sources_and_places_batches():
    src = ({"x": np.full((2,), i, np.float32)} for i in range(3))
    pf = Prefetcher(src, place=make_placer("cpu"))
    got = [b["x"] for b in pf]
    assert [int(t[0]) for t in got] == [0, 1, 2]
    assert all(isinstance(t, torch.Tensor) for t in got)
    with pytest.raises(StopIteration):   # keeps raising after the end
        next(pf)
    pf.close()


def test_prefetcher_reraises_a_crashed_source():
    def src():
        yield {"x": np.zeros(1)}
        raise KeyError("boom")

    pf = Prefetcher(src())
    next(pf)
    with pytest.raises(KeyError, match="boom"):
        next(pf)
    pf.close()


def test_prefetcher_close_joins_a_blocked_worker():
    def endless():
        while True:
            yield {"x": np.zeros(1)}

    before = threading.active_count()
    pf = Prefetcher(endless(), depth=1)
    next(pf)
    pf.close()
    assert not pf._t.is_alive()
    assert threading.active_count() == before
