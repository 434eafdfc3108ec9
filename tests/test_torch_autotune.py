"""The port's ``comm="auto"`` autotuner (``repro_torch.telemetry.autotune``)
against the reference's (``repro.telemetry.autotune``), after
``tests/test_telemetry.py`` and ``tests/test_wire_formats.py``.

The fit and the closed-form choice are numpy and Python floats in both
packages, so on the same synthetic probes they must agree exactly.  The
probes themselves time live collectives, so the tests that drive
``autotune_comm`` either replace the timing with the §3.2 model's own
times (the fitted constants and the plan are then the model's) or check
only what does not depend on the clock: that a run with the chosen plan is
bitwise a run given that plan outright, that a cached plan skips the
probes, that top-k is never chosen, and that the cluster's supervisor
drops the cache when the world size changes.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _gloo_ranks import run_ranks  # noqa: E402
from repro.telemetry import autotune as jauto  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, TelemetrySpec, compile_run  # noqa: E402
from repro_torch.cluster import elastic  # noqa: E402
from repro_torch.cluster.launcher import (  # noqa: E402
    WorkerHandle,
    _worker_env,
    autotune_cache_path,
    invalidate_autotune_cache,
    result_path,
)
from repro_torch.cluster.spec import ClusterSpec  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.telemetry import ENV_AUTOTUNE_CACHE, Recorder  # noqa: E402
from repro_torch.telemetry import autotune  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMOKE = dict(arch="vgg-a", smoke=True, steps=3, batch=8, lr=5e-3,
             schedule="constant", log_every=1)
LAT, BW = 7.5e-6, 3.0e10


def _quiet(*_a, **_k):
    pass


def _model_seconds(nbytes, G, lat=LAT, bw=BW):
    return 2.0 * (G - 1) * lat + 2.0 * (G - 1) / G * nbytes / bw


def _probes(mod, G, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [4096, 65536, 1 << 20, 3 << 20, 40 << 20]
    return [mod.CommProbe(nbytes=n, seconds=_model_seconds(n, G)
                          * (1.0 + noise * rng.standard_normal()),
                          backend="pallas-ring") for n in sizes]


@pytest.mark.parametrize("noise", [0.0, 0.05])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 64])
def test_fit_and_choice_equal_the_reference(G, noise):
    lat, bw = autotune.fit_comm_model(_probes(autotune, G, noise), G)
    jlat, jbw = jauto.fit_comm_model(_probes(jauto, G, noise), G)
    assert (lat, bw) == (jlat, jbw)
    if G > 1 and noise == 0.0:
        np.testing.assert_allclose([lat, bw], [LAT, BW], rtol=1e-9)
    for total in (4 * 1000, 4 * 132_863_336):
        for fmt in ("fp32", "bf16", "int8", "topk"):
            assert autotune.choose_bucket_bytes(total, G, lat, bw, fmt) == \
                jauto.choose_bucket_bytes(total, G, jlat, jbw, fmt)
    assert autotune.fit_comm_model([], G) == jauto.fit_comm_model([], G)
    assert (autotune.MIN_LATENCY_S, autotune.MAX_BANDWIDTH,
            autotune.ENV_AUTOTUNE_CACHE) == (
        jauto.MIN_LATENCY_S, jauto.MAX_BANDWIDTH, jauto.ENV_AUTOTUNE_CACHE)
    h = autotune.measured_hw(lat, bw)
    jh = jauto.measured_hw(jlat, jbw)
    assert (h.sw_latency, h.link_bw) == (jh.sw_latency, jh.link_bw)


def test_probe_sizes_equal_the_reference():
    """The candidate buffer sizes come from the bucket planner over the
    param tree's shapes, the same in both packages."""
    from repro_torch.api.families import adapter_for
    from repro_torch.configs import get_config, smoke_variant
    cfg = smoke_variant(get_config("vgg-a"))
    params = adapter_for(cfg).init(cfg, 0, torch.device("cpu"))
    nparams = {k: np.zeros(tuple(v.shape), np.float32)
               for k, v in params.items()}
    total = sum(v.numel() for v in params.values()) * 4
    for G in (1, 2, 4, 8):
        assert autotune._probe_sizes(params, G, total, 4) == \
            jauto._probe_sizes(nparams, G, total, 4)
    tiny = {"w": torch.zeros(4096)}
    assert autotune._probe_sizes(tiny, 4, 4 * 4096, 4) == \
        jauto._probe_sizes({"w": np.zeros(4096, np.float32)}, 4, 4 * 4096, 4)


def test_cache_save_load_round_trip(tmp_path):
    path = str(tmp_path / "cache.json")
    key = autotune._cache_key(4, ("data",), 100, ["lax"], ["fp32", "int8"])
    assert key == jauto._cache_key(4, ("data",), 100, ["lax"],
                                   ["fp32", "int8"])
    plan = {"bucket_bytes": 65536, "chosen_backend": "lax",
            "chosen_wire_format": "int8"}
    assert autotune._load_cached_plan(path, key) is None
    autotune._save_cached_plan(path, key, plan)
    assert autotune._load_cached_plan(path, key) == plan
    # the file is the reference's: either package reads the other's
    assert jauto._load_cached_plan(path, key) == plan
    assert autotune._load_cached_plan(path, dict(key, G=2)) is None
    with open(path, "w") as f:
        f.write("{not json")
    assert autotune._load_cached_plan(path, key) is None


def _model_timing(mesh, axis_arg, base, backend, wire_format, G, sizes,
                  reps, recorder):
    """``_time_backend`` with the §3.2 model's times in place of the clock:
    the lax backend twice as slow a message as the ring, and each wire
    format's roundtrip moving its reduce side at the format's
    bytes-on-wire factor (``core.balance.wire_reduce_factor``)."""
    from repro_torch.core.balance import wire_reduce_factor
    lat = LAT * (2.0 if backend == "lax" else 1.0)
    moved = (1.0 + wire_reduce_factor(wire_format)) / 2.0
    return [autotune.CommProbe(n * 4, _model_seconds(n * 4 * moved, G, lat),
                               backend, wire_format) for n in sizes]


def test_model_probes_give_the_closed_form_plan_never_topk(monkeypatch):
    monkeypatch.setattr(autotune, "_time_backend", _model_timing)
    params = {"b": torch.zeros(512), "w": torch.zeros(200_000)}
    mesh = make_local_mesh(4, device="cpu")
    rec = Recorder()
    comm = autotune.autotune_comm(
        params, mesh, ("data",), CommConfig(), recorder=rec,
        backends=("lax", "pallas-ring"), log=_quiet,
        wire_formats=("fp32", "bf16", "int8", "topk"))
    # the ring's constants win, and the format whose roundtrip moves the
    # fewest bytes, int8; top-k is never probed
    assert comm.backend == "pallas-ring" and comm.wire_format == "int8"
    plan = [e for e in rec.events if e["kind"] == "autotune_plan"]
    assert len(plan) == 1 and "topk" not in plan[0]["wire_formats"]
    assert sorted(plan[0]["fits"]) == sorted(
        f"{b}/{f}" for b in ("lax", "pallas-ring")
        for f in ("fp32", "bf16", "int8"))
    # each pair is fitted on its own: int8's measured bandwidth is the
    # dense one over its reduce factor's share, (1 + 1/4) / 2
    np.testing.assert_allclose([plan[0]["sw_latency_s"],
                                plan[0]["link_bw_Bps"]], [LAT, BW / 0.625],
                               rtol=1e-9)
    np.testing.assert_allclose(plan[0]["fits"]["pallas-ring/fp32"][:2],
                               [LAT, BW], rtol=1e-9)
    # the bucket is the closed form at the chosen pair's own constants,
    # and on the model's own times that is the reference's closed form for
    # int8 at the dense constants (up to the fit's rounding)
    total = (200_000 + 512) * 4
    assert comm.bucket_bytes == jauto.choose_bucket_bytes(
        total, 4, plan[0]["sw_latency_s"], plan[0]["link_bw_Bps"])
    np.testing.assert_allclose(comm.bucket_bytes, jauto.choose_bucket_bytes(
        total, 4, LAT, BW, "int8"), rtol=1e-6)
    assert "device memory traffic" in plan[0]["measured"]


def test_a_failing_kernel_probe_is_raised_not_skipped(monkeypatch):
    """A candidate backend whose kernels fail to build or launch stops the
    autotuner: it never hands the run to another backend."""
    from repro_torch.comm.backends.ring import RingBackend

    def broken(self, *a, **k):
        raise RuntimeError("ring kernel failed to build")
    monkeypatch.setattr(RingBackend, "part_reduce", broken)
    mesh = make_local_mesh(4, device="cpu")
    with pytest.raises(RuntimeError, match="failed to build"):
        autotune.autotune_comm({"w": torch.zeros(4096)}, mesh, ("data",),
                               CommConfig(), backends=("lax", "pallas-ring"),
                               reps=1, log=_quiet, wire_formats=("fp32",))


def test_pairs_the_mesh_refuses_are_not_probed(monkeypatch):
    """Only the plain dense reduce-scatter is dropped where the mesh
    refuses it (a card's buffers over gloo); the int8 ring of the same
    backend, and the other backend, are probed."""
    monkeypatch.setattr(autotune, "refuses_plain_reduce",
                        lambda mesh, axis: True)
    monkeypatch.setattr(autotune, "_time_backend", _model_timing)
    rec = Recorder()
    autotune.autotune_comm({"w": torch.zeros(4096)},
                           make_local_mesh(4, device="cpu"), ("data",),
                           CommConfig(), recorder=rec,
                           backends=("lax", "pallas-ring"), reps=1,
                           log=_quiet, wire_formats=("fp32", "bf16", "int8"))
    plan = [e for e in rec.events if e["kind"] == "autotune_plan"][0]
    assert sorted(plan["fits"]) == ["lax/int8", "pallas-ring/bf16",
                                    "pallas-ring/fp32", "pallas-ring/int8"]
    with pytest.raises(ValueError, match="refuses every candidate"):
        autotune.autotune_comm({"w": torch.zeros(4096)},
                               make_local_mesh(4, device="cpu"), ("data",),
                               CommConfig(), backends=("lax",), reps=1,
                               log=_quiet, wire_formats=("fp32",))


def test_cache_hit_skips_probing(tmp_path, monkeypatch):
    params = {"b": torch.zeros(128), "w": torch.zeros(4096)}
    mesh = make_local_mesh(4, device="cpu")
    path = str(tmp_path / "autotune_cache.json")
    kw = dict(backends=["lax"], reps=1, log=_quiet,
              wire_formats=("fp32", "bf16", "int8"), cache_path=path)
    first = autotune.autotune_comm(params, mesh, ("data",), CommConfig(),
                                   **kw)
    with open(path) as f:
        saved = json.load(f)
    assert saved["plan"]["chosen_backend"] == first.backend
    assert saved["plan"]["chosen_wire_format"] == first.wire_format
    assert saved["plan"]["bucket_bytes"] == first.bucket_bytes

    def boom(*a, **k):
        raise RuntimeError("probe ran despite a cached plan")

    monkeypatch.setattr(autotune, "_time_backend", boom)
    assert autotune.autotune_comm(params, mesh, ("data",), CommConfig(),
                                  **kw) == first
    # another candidate set is another key: it probes again
    with pytest.raises(RuntimeError, match="probe ran"):
        autotune.autotune_comm(params, mesh, ("data",), CommConfig(),
                               **dict(kw, wire_formats=("fp32",)))


@pytest.mark.parametrize("parallel", ["zero1", "stale-sync"])
def test_auto_run_is_bitwise_the_fixed_run_at_its_plan(parallel, monkeypatch):
    """``comm="auto"`` resolves before the strips are laid out; training
    with the plan it chose is then bitwise a run given that plan.  The
    probes' count and kind reach the trace (``autotune_reps``)."""
    monkeypatch.delenv(ENV_AUTOTUNE_CACHE, raising=False)
    mesh = MeshSpec(members_per_device=4)
    rec = Recorder()
    auto = compile_run(RunSpec(**SMOKE, parallel=parallel, mesh=mesh,
                               comm="auto",
                               telemetry=TelemetrySpec(autotune_reps=3)),
                       device="cpu", recorder=rec)
    assert isinstance(auto.comm, CommConfig)
    assert auto.comm.wire_format in ("fp32", "bf16", "int8")
    probes = [e for e in rec.events if e["kind"] == "collective"]
    plan = [e for e in rec.events if e["kind"] == "autotune_plan"][0]
    assert len(probes) == 3 * plan["probes"] and probes
    assert {e["phase"] for e in probes} == {"autotune-probe"}
    assert any(e["kind"] == "autotune" for e in rec.events)
    fixed = compile_run(RunSpec(**SMOKE, parallel=parallel, mesh=mesh,
                                comm=auto.comm), device="cpu")
    with auto, fixed:
        ha = auto.fit(log_fn=_quiet)
        hf = fixed.fit(log_fn=_quiet)
    assert [h["loss"] for h in ha] == [h["loss"] for h in hf]
    for k in auto.params:
        assert torch.equal(auto.params[k], fixed.params[k]), k


def test_launcher_exports_the_cache_path(tmp_path):
    env = _worker_env(ClusterSpec(num_processes=2, process_id=1),
                      str(tmp_path / "hb"), None, str(tmp_path))
    assert env[ENV_AUTOTUNE_CACHE] == autotune_cache_path(str(tmp_path))
    assert autotune_cache_path("d") == jauto_cache_path("d")
    assert not invalidate_autotune_cache(str(tmp_path))


def jauto_cache_path(run_dir):
    from repro.cluster.launcher import autotune_cache_path as j
    return j(run_dir)


class _FakeProc:
    def __init__(self, returncode):
        self.returncode = returncode

    def poll(self):
        return self.returncode

    def wait(self):
        return self.returncode


def _elastic_fixture(tmp_path, monkeypatch, first_rcs):
    """``spawn_workers`` replaced: attempt 0 returns handles that exited
    with ``first_rcs``, later attempts a healthy group; the autotune cache
    and worker 0's result are written beforehand."""
    run_dir = str(tmp_path)
    cache = autotune_cache_path(run_dir)
    with open(cache, "w") as f:
        json.dump({"key": {"G": 2}, "plan": {"bucket_bytes": 1}}, f)
    with open(result_path(run_dir), "w") as f:
        json.dump({"final_loss": 1.0}, f)
    calls = []

    def handle(pid, rc):
        return WorkerHandle(proc=_FakeProc(rc), process_id=pid,
                            hb_file=os.path.join(run_dir, f"hb_{pid}"),
                            log_file=None)

    def fake_spawn(world, argv, rd, attempt=0, local_devices=1,
                   coordinator=None):
        calls.append((attempt, world))
        if attempt == 0:
            return [handle(i, rc) for i, rc in enumerate(first_rcs)]
        return [handle(i, 0) for i in range(world)]

    monkeypatch.setattr(elastic, "spawn_workers", fake_spawn)
    return run_dir, cache, calls


def test_elastic_shrink_invalidates_the_cache(tmp_path, monkeypatch):
    run_dir, cache, calls = _elastic_fixture(tmp_path, monkeypatch, [0, -9])
    logs = []
    res = elastic.run_elastic(["worker"], run_dir, num_processes=2,
                              poll_interval=0.01, log=logs.append)
    assert res.final_world == 1 and res.attempts == 2
    assert calls == [(0, 2), (1, 1)]
    assert not os.path.exists(cache)
    assert any("invalidated" in str(x) for x in logs), logs


def test_elastic_grow_back_keeps_the_cache(tmp_path, monkeypatch):
    run_dir, cache, calls = _elastic_fixture(tmp_path, monkeypatch, [0, -9])
    res = elastic.run_elastic(["worker"], run_dir, num_processes=2,
                              poll_interval=0.01, grow_back=True,
                              log=_quiet)
    assert res.final_world == 2 and calls == [(0, 2), (1, 2)]
    assert os.path.exists(cache)


WORKER = """
import os, sys
import numpy as np, torch, torch.distributed as dist
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch.api import MeshSpec, RunSpec, compile_run
from repro_torch.telemetry import Recorder
rec = Recorder()
run = compile_run(RunSpec(arch="vgg-a", smoke=True, steps=2, batch=8,
                          lr=5e-3, schedule="constant", log_every=1,
                          parallel="stale-sync", comm="auto",
                          mesh=MeshSpec(cluster=True)),
                  device="cpu", recorder=rec)
plan = [e for e in rec.events if e["kind"] == "autotune_plan"][0]
hist = run.fit(log_fn=lambda *_: None)
run.close()
out = {f"p/{k}": v.detach().numpy() for k, v in run.params.items()}
out["loss"] = np.array([h["loss"] for h in hist])
out["plan"] = np.array([plan["sw_latency_s"], plan["link_bw_Bps"],
                        plan["bucket_bytes"]], np.float64)
out["choice"] = np.array([run.comm.backend, run.comm.wire_format])
np.savez(f"{tmp}/rank{rank}.npz", **out)
dist.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def test_gloo_ranks_average_their_probes_and_agree(tmp_path):
    """On a process mesh each rank times its own probes; the times are
    averaged over the ranks before the fit, so both ranks fit the same
    constants bit for bit, pick the same plan and train it in step
    (bucket plans that differed would deadlock the first collective)."""
    run_ranks(WORKER, 2, tmp_path, SRC)
    ranks = []
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    assert np.all(np.isfinite(ranks[0]["loss"]))
