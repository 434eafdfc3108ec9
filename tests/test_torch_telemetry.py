"""The port's telemetry (``repro_torch.telemetry``) against the JAX
package's: the recorder's spans, counts, listeners and JSONL sink, and,
from the same injected clock and the same events, the Chrome trace and the
merge of the processes' traces equal to the reference's, key for key.  Then
a traced run through ``compile_run``: the trainer's spans (``step``,
``data_wait``, ``first_step``, ``ckpt_write``) in the merged trace, and the
trainer's throughput unit (tokens for an LM batch, rows otherwise) against
the reference's ``_batch_items``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import telemetry as jtel  # noqa: E402
from repro.train.trainer import _batch_items as j_batch_items  # noqa: E402
from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.api import RunSpec, TelemetrySpec, compile_run  # noqa: E402
from repro_torch.train.trainer import _batch_items  # noqa: E402


class _Clock:
    """A deterministic clock: 0.5, 1.25, 2.0, ... on successive reads."""

    def __init__(self):
        self.t = -0.25

    def __call__(self):
        self.t += 0.75
        return self.t


def _record(pkg, clock, process_index=0):
    """The same spans, events and counts on ``pkg``'s Recorder."""
    r = pkg.Recorder(process="train", process_index=process_index,
                     clock=clock)
    seen = []
    r.add_listener(seen.append)
    r.event("meta", process="train", process_index=process_index,
            clock="monotonic")
    with r.span("step", step=1):
        with r.span("first_step", step=1):
            pass
        with r.span("ckpt_write", step=1):
            pass
    r.count("steps")
    r.count("items_tok", 128)
    r.gauge("lr", 1e-3)
    r.close()
    return r, seen


def test_recorder_events_and_metrics_match_the_reference():
    got, seen = _record(tel, _Clock())
    want, _ = _record(jtel, _Clock())
    assert got.events == want.events
    assert seen == got.events    # listeners see every event, in order
    assert [e["kind"] for e in got.events] == [
        "meta", "first_step", "ckpt_write", "step", "metrics"]
    step = next(e for e in got.events if e["kind"] == "step")
    assert step["depth"] == 0 and step["dur"] == step["t1"] - step["t0"]
    assert got.metrics() == want.metrics()
    assert got.metrics()["counters"] == {"items_tok": 128, "steps": 1}


def test_recorder_close_is_idempotent_and_null_recorder_is_a_no_op():
    r = tel.Recorder()
    r.close()
    r.close()
    assert sum(e["kind"] == "metrics" for e in r.events) == 1
    null, jnull = tel.NULL_RECORDER, jtel.NULL_RECORDER
    with null.span("step", step=1):
        null.count("steps")
        null.gauge("lr", 1.0)
        null.event("x")
        null.hist("span/step_s").observe(1.0)
    null.add_listener(print)
    null.close()
    assert null.hist("x").summary() == jnull.hist("x").summary()
    assert (null.enabled, null.sync, null.trace_dir, null.process_index) \
        == (jnull.enabled, jnull.sync, jnull.trace_dir, jnull.process_index)


def test_chrome_events_and_merge_match_the_reference(tmp_path):
    dirs = {}
    for name, pkg in (("port", tel), ("ref", jtel)):
        d = tmp_path / name
        d.mkdir()
        for idx in (0, 1):
            r = pkg.Recorder(process="train", process_index=idx,
                             clock=_Clock())
            sink = pkg.JsonlSink(pkg.trace_path(str(d), idx))
            r.add_listener(sink)
            r.event("meta", process="train", process_index=idx)
            with r.span("step", step=1):
                with r.span("ckpt_write", step=1):
                    pass
            r.close()
        dirs[name] = str(d)
    events = tel.read_jsonl(tel.trace_path(dirs["port"], 1))
    assert events == jtel.read_jsonl(jtel.trace_path(dirs["ref"], 1))
    assert tel.to_chrome_events(events, pid=1, name="train[1]") == \
        jtel.to_chrome_events(events, pid=1, name="train[1]")
    merged = tel.merge_process_traces(dirs["port"])
    assert merged == os.path.join(dirs["port"], "trace.json")
    with open(merged) as f, \
            open(jtel.merge_process_traces(dirs["ref"])) as g:
        assert json.load(f) == json.load(g)
    assert tel.merge_process_traces(str(tmp_path)) is None


def test_histogram_summary_matches_numpy():
    vals = np.random.default_rng(0).lognormal(size=101)
    h = tel.Histogram()
    for v in vals:
        h.observe(v)
    s = h.summary()
    assert s["count"] == 101 and s["max"] == pytest.approx(vals.max())
    assert s["p99"] == pytest.approx(np.percentile(vals, 99))
    assert tel.Histogram().summary() == tel.NullHistogram().summary()


def test_telemetry_spec_coercion():
    from repro.api import TelemetrySpec as JTelemetrySpec
    spec = RunSpec(arch="vgg-a", telemetry="/tmp/trace")
    assert spec.telemetry == TelemetrySpec(trace_dir="/tmp/trace")
    assert spec.telemetry.autotune_reps == JTelemetrySpec().autotune_reps
    with pytest.raises(ValueError):
        RunSpec(arch="vgg-a", telemetry=3)
    for cls in (TelemetrySpec, JTelemetrySpec):
        with pytest.raises(ValueError, match="autotune_reps"):
            cls(autotune_reps=0)
    # validated, and the autotuner it feeds times each probe that often
    rec = tel.Recorder()
    run = compile_run(RunSpec(arch="vgg-a", smoke=True, parallel="zero1",
                              comm="auto", telemetry=TelemetrySpec(
                                  autotune_reps=3)), device="cpu",
                      recorder=rec)
    run.close()
    probes = [e for e in rec.events if e["kind"] == "collective"]
    reps = {e["rep"] for e in probes}
    assert probes and reps == {0, 1, 2}


def test_traced_run_writes_trainer_spans(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_PROCESS_ID", raising=False)
    trace, ck = str(tmp_path / "trace"), str(tmp_path / "ckpt")
    spec = RunSpec(arch="vgg-a", smoke=True, steps=3, batch=4,
                   schedule="constant", ckpt_every=2, ckpt_dir=ck,
                   telemetry=trace)
    with compile_run(spec, device="cpu") as run:
        assert run.telemetry.sync and run.telemetry.trace_dir == trace
        run.fit(log_fn=lambda *_: None)
    with open(os.path.join(trace, "trace.json")) as f:
        evs = json.load(f)["traceEvents"]
    spans = [e["name"] for e in evs if e.get("ph") == "X"]
    assert spans.count("step") == spans.count("data_wait") == 3
    assert spans.count("first_step") == 1 and spans.count("ckpt_write") == 1
    metrics = tel.read_jsonl(tel.trace_path(trace, 0))[-1]
    assert metrics["kind"] == "metrics"
    assert metrics["counters"] == {"items_samples": 8, "steps": 3}


def test_batch_items_match_the_reference():
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, 9, (2, 16)).astype(np.int32)},
               {"codebook_labels": np.zeros((2, 16, 4), np.int32)},
               {"images": np.zeros((5, 8, 8, 3), np.float32),
                "labels": np.zeros((5,), np.int32)},
               {"frames": np.zeros((7, 11), np.float32),
                "senones": np.zeros((7,), np.int32)}]
    for b in batches:
        assert _batch_items({k: torch.tensor(v) for k, v in b.items()}) \
            == j_batch_items(b)
    assert _batch_items(
        {"tokens": torch.zeros(2, 16, dtype=torch.int32)}) == (32, "tok")
