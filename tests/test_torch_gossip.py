"""The port's GossipGraD partner exchange (``repro_torch.comm.backends.
gossip``, ``parallel="gossip"``) against the reference's.

The reference runs on forced host devices in one subprocess for this module
(``--xla_force_host_platform_device_count=4``, as ``tests/test_torch_dist.py``
does), its ``GossipBackend`` inside ``shard_map``; the port on a local mesh
(one CPU tensor row per member) and, for the gloo case, as 4 CPU processes.

Every member of a local mesh enters a training step with the same global
gradient, so there the pair mean equals the group mean up to rounding; the
rotation only shows with distinct member partials, which the backend-level
cases and the process mesh give it.

Tolerances: the backend's pair sums within rtol 1e-6 in f32 (bitwise
expected: the same two adds and the same scale), and within one bf16 ulp
(2**-7 relative) in bf16; the ``compile_run`` loss and grad-norm history
within 1e-5 per step over 3 steps (``tests/test_torch_dist.py``'s zero1
bound); the gloo ranks' pair sums bitwise the local mesh's; gossip at G = 2
against the port's zero1 at rtol 1e-6, atol 1e-7: float tolerance, not
bitwise, since the reference's bitwise identity is a known caveat of its
own (``tests/test_distributed.py::test_gossip_g2_matches_zero1_bitwise``).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _gloo_ranks import run_group, run_ranks  # noqa: E402
from repro.optim.sgd import SgdState as JSgdState  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.comm import CommConfig, RingBackend, get_backend  # noqa: E402
from repro_torch.comm.backends.gossip import (  # noqa: E402
    GossipBackend,
    _shift_perm,
    shift_of,
)
from repro_torch.comm.schedule import make_schedule  # noqa: E402
from repro_torch.interop import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import ring as kring  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.optim import MomentumSGD  # noqa: E402
from repro_torch.optim.dist import make_distributed_update  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GROUPS = (2, 3, 4)
STEPS = range(4)
N_CHUNK = 24                      # elements of one member's chunk
BF16_TOL = 2.0 ** -7
SMOKE = dict(arch="vgg-a", smoke=True, steps=3, batch=8, lr=5e-3,
             schedule="constant", log_every=1)


def _rows(G, seed=0):
    """G distinct member buffers of G chunks each."""
    rng = np.random.default_rng(seed + G)
    return rng.normal(size=(G, G * N_CHUNK)).astype(np.float32)


def _bf16(x):
    return torch.tensor(x).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference result of this module, from one subprocess."""
    tmp = tmp_path_factory.mktemp("reference_gossip")
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **{f"x/{G}": _rows(G) for G in GROUPS})
    out = os.path.join(str(tmp), "reference.npz")
    code = textwrap.dedent(f"""
        import repro.jaxcompat
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType, PartitionSpec as P
        from repro.api import MeshSpec, RunSpec, compile_run
        from repro.comm import CommConfig
        from repro.comm.backends import get_backend
        from repro.comm.schedule import bind_step, make_schedule
        z = np.load({inputs!r})
        out = {{}}
        for G in {GROUPS!r}:
            mesh = jax.make_mesh((G,), ("data",), devices=jax.devices()[:G],
                                 axis_types=(AxisType.Auto,))
            for dt in ("f32", "bf16"):
                x = jnp.asarray(z[f"x/{{G}}"]).astype(
                    jnp.float32 if dt == "f32" else jnp.bfloat16)
                for step in {list(STEPS)!r}:
                    b = bind_step(get_backend("gossip"), jnp.asarray(step))
                    f = jax.jit(jax.shard_map(
                        lambda row: b.part_reduce(row[0], "data")[None],
                        mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                        check_vma=False))
                    with jax.set_mesh(mesh):
                        got = f(x)
                    assert got.dtype == x.dtype
                    out[f"pair/{{G}}/{{dt}}/{{step}}"] = np.asarray(
                        got.astype(jnp.float32))
        mesh = jax.make_mesh((2, 2), ("pod", "data"),
                             axis_types=(AxisType.Auto,) * 2)
        x = jnp.asarray(z["x/4"])
        for step in {list(STEPS)!r}:
            sched = make_schedule(("pod", "data"), True, "gossip", "lax",
                                  step=jnp.asarray(step))
            f = jax.jit(jax.shard_map(
                lambda row: sched.reduce(row[0], jnp.float32)[None],
                mesh=mesh, in_specs=P(("pod", "data")),
                out_specs=P(("pod", "data")), check_vma=False))
            with jax.set_mesh(mesh):
                out[f"hier/{{step}}"] = np.asarray(f(x))
        spec = RunSpec(arch="vgg-a", smoke=True, steps=3, batch=8, lr=5e-3,
                       schedule="constant", log_every=1, parallel="gossip",
                       comm=CommConfig(bucket_bytes=1 << 16,
                                       backend="gossip"))
        run = compile_run(spec)
        for k, v in run.params.items():
            out[f"run/p0/{{k}}"] = np.asarray(v)
        for i, s in enumerate(run.opt_state.velocity):
            out[f"run/s0/{{i}}"] = np.asarray(s)
        hist = run.fit(log_fn=lambda *_: None)
        run.close()
        out["run/loss"] = np.array([h["loss"] for h in hist])
        out["run/grad_norm"] = np.array([h["grad_norm"] for h in hist])
        np.savez({out!r}, **out)
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("G", GROUPS)
def test_pair_sums_match_reference_on_distinct_members(reference, G, step,
                                                       dt):
    x = _rows(G)
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    mesh = make_local_mesh(G, device="cpu")
    b = get_backend("gossip").bind_step(step)
    got = b.part_reduce(torch.tensor(x).to(tdt), mesh, "data")
    assert got.dtype == tdt and got.shape == (G, N_CHUNK)
    want = reference[f"pair/{G}/{dt}/{step}"]
    tol = 1e-6 if dt == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=0)
    # the rotation itself: member p's pair is p and p - s, at the scale G/2
    s = shift_of(step, G)
    xs = x if dt == "f32" else _bf16(x)
    ch = xs.reshape(G, G, N_CHUNK)
    pair = np.stack([(ch[p, p] + ch[(p - s) % G, p]) * (G / 2.0)
                     for p in range(G)])
    np.testing.assert_allclose(got.float().numpy(), pair, rtol=tol, atol=0)
    assert sorted(d for _, d in _shift_perm(G, s)) == list(range(G))


@pytest.mark.parametrize("step", STEPS)
def test_hierarchical_composition_matches_reference(reference, step):
    """pods = 2: the in-pod pair sum times G_in / 2, then the cross-pod
    sum over the lax backend, each member's strip in owner order."""
    mesh = make_local_mesh(4, pods=2, device="cpu")
    sched = make_schedule(mesh, ("pod", "data"), hierarchical=True,
                          backend="gossip", cross_backend="lax", step=step)
    got = sched.reduce(torch.tensor(_rows(4)), torch.float32)
    np.testing.assert_allclose(got.numpy(), reference[f"hier/{step}"],
                               rtol=1e-6, atol=1e-7)
    # the update plan binds the live step into the backend at both levels
    from repro_torch.optim.dist import UpdatePlan
    up = UpdatePlan.build(MomentumSGD(), mesh, ("pod", "data"), CommConfig(
        backend="gossip", cross_backend="gossip", hierarchical=True))
    sched = up.schedule(step)
    assert sched.inner_backend.step == step == sched.outer_backend.step


def test_compile_run_gossip_matches_reference(reference):
    spec = RunSpec(**SMOKE, parallel="gossip",
                   mesh=MeshSpec(members_per_device=4),
                   comm=CommConfig(bucket_bytes=1 << 16, backend="gossip"))
    keys = sorted(k.split("/")[-1] for k in reference
                  if k.startswith("run/p0/"))
    run = compile_run(spec, device="cpu")
    assert isinstance(run.dist_update.plan.schedule(1).backend,
                      GossipBackend)
    want_s0 = [reference[f"run/s0/{i}"]
               for i in range(len(run.opt_state.velocity))]
    assert [tuple(s.shape) for s in run.opt_state.velocity] == \
        [s.shape for s in want_s0]
    run.params = params_from_numpy({k: reference[f"run/p0/{k}"]
                                    for k in keys}, "cpu")
    run.opt_state = opt_state_from_numpy(JSgdState(velocity=want_s0), "cpu")
    with run:
        hist = run.fit(log_fn=lambda *_: None)
    assert [h["step"] for h in hist] == [1, 2, 3]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in hist],
                                   reference[f"run/{k}"], rtol=1e-5,
                                   err_msg=k)


def test_default_gossip_run_is_flat_and_steps_the_rotation():
    """``comm=None`` takes the gossip backend on a flat schedule even with
    pods (a hierarchical one would scope the rotation to each pod), and the
    train step binds its index into the backend."""
    run = compile_run(RunSpec(**SMOKE, parallel="gossip",
                              mesh=MeshSpec(members_per_device=4, pods=2)),
                      device="cpu")
    assert run.comm.backend == "gossip" and not run.comm.hierarchical
    seen = []
    real = GossipBackend.part_reduce

    def spy(self, x, mesh, axis_name):
        seen.append(self.step)
        return real(self, x, mesh, axis_name)

    GossipBackend.part_reduce = spy
    try:
        with run:
            run.fit(log_fn=lambda *_: None)
    finally:
        GossipBackend.part_reduce = real
    n = run.dist_update.plan.buckets(run.params).n_collectives
    assert seen == [0] * n + [1] * n + [2] * n


def test_member_batched_pair_add_is_each_members_hop():
    """The local mesh's one launch a bucket (``ring_hop_accum_members``)
    against ``ring_hop_accum`` of each member, bitwise, on distinct rows
    and on one buffer viewed G times."""
    for G in GROUPS:
        x = torch.tensor(_rows(G, seed=5))
        for rows in (x, x[0].expand(G, -1)):
            recv = torch.tensor(_rows(G, seed=6)[:, :N_CHUNK])
            got = kring.ring_hop_accum_members(rows, recv)
            for p in range(G):
                assert torch.equal(got[p], kring.ring_hop_accum(
                    rows[p].reshape(G, -1).contiguous(), recv[p], p))
    with pytest.raises(ValueError):
        kring.ring_hop_accum_members(x, recv[:, :-1])


def test_gossip_at_two_members_is_zero1_to_float_tolerance():
    """At G = 2 the only partner is the other member, so gossip mixes the
    whole group: on distinct member partials its strips and, through the
    update, its params and state agree with zero1's at float tolerance."""
    mesh = make_local_mesh(2, device="cpu")
    x = torch.tensor(_rows(2, seed=9))
    for step in STEPS:
        g = GossipBackend(step=step).part_reduce(x, mesh, "data")
        torch.testing.assert_close(g, RingBackend().part_reduce(
            x, mesh, "data"), rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(3)
    params = {"b": rng.normal(size=(11,)).astype(np.float32),
              "w": rng.normal(size=(37,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    out = {}
    for backend in ("lax", "pallas-ring", "gossip"):
        init_fn, upd = make_distributed_update(
            MomentumSGD(momentum=0.9), mesh,
            comm=CommConfig(bucket_bytes=64, backend=backend))
        p = params_from_numpy(params, "cpu")
        st = init_fn(p)
        for t, g in enumerate(grads):
            p, st = upd(p, params_from_numpy(g, "cpu"), st, 0.05, t)
        out[backend] = (p, st)
    for backend in ("lax", "pallas-ring"):
        for k in params:
            torch.testing.assert_close(out["gossip"][0][k],
                                       out[backend][0][k], rtol=1e-6,
                                       atol=1e-7)
        for a, b in zip(out["gossip"][1].velocity,
                        out[backend][1].velocity):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the process mesh: 4 CPU processes over gloo
# ---------------------------------------------------------------------------
WORKER = """
import os, sys
import numpy as np, torch, torch.distributed as dist
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from repro_torch.api import MeshSpec, RunSpec, compile_run
from repro_torch.comm.backends.gossip import GossipBackend
from repro_torch.launch.mesh import make_process_mesh
x = np.load(tmp + "/inputs.npz")["x"]
mesh = make_process_mesh(device="cpu")
out = {}
for step in range(3):
    for dt in (torch.float32, torch.bfloat16):
        s = GossipBackend(step=step).part_reduce(
            torch.tensor(x[rank]).to(dt), mesh, "data")
        out[f"pair/{step}/{dt}"] = s.float().numpy()
run = compile_run(RunSpec(arch="vgg-a", smoke=True, steps=3, batch=8,
                          lr=5e-3, schedule="constant", log_every=1,
                          parallel="gossip", mesh=MeshSpec(cluster=True)),
                  device="cpu")
assert run.comm.backend == "gossip" and not run.comm.hierarchical
hist = run.fit(log_fn=lambda *_: None)
run.close()
out["loss"] = np.array([h["loss"] for h in hist])
for k, v in run.params.items():
    out[f"p/{k}"] = v.detach().numpy()
np.savez(f"{tmp}/rank{rank}.npz", **out)
dist.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def test_gloo_ranks_pair_like_the_local_mesh_and_stay_replicated(tmp_path):
    world = 4
    x = _rows(world, seed=11)
    np.savez(tmp_path / "inputs.npz", x=x)
    run_ranks(WORKER, world, tmp_path, SRC)
    ranks = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    local = make_local_mesh(world, device="cpu")
    for step in range(3):
        for dt in (torch.float32, torch.bfloat16):
            want = GossipBackend(step=step).part_reduce(
                torch.tensor(x).to(dt), local, "data").float().numpy()
            for r in range(world):
                np.testing.assert_array_equal(
                    ranks[r][f"pair/{step}/{dt}"], want[r],
                    err_msg=f"step {step} {dt} rank {r}")
    for r in range(1, world):
        np.testing.assert_array_equal(ranks[r]["loss"], ranks[0]["loss"])
        for k in ranks[0]:
            if k.startswith("p/"):
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                              err_msg=f"rank {r} {k}")
    assert np.all(np.isfinite(ranks[0]["loss"]))


def test_cluster_cli_runs_gossip_and_verifies(tmp_path):
    """``python -m repro_torch.launch.cluster --parallel gossip`` as a user
    runs it: 2 gloo processes on the CPU, held by ``--verify`` to one
    process within ``launch.cluster.VERIFY_TOL``."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("REPRO_PROCESS_ID", None)
    out = run_group([sys.executable, "-m", "repro_torch.launch.cluster",
                     "--processes", "2", "--arch", "vgg-a", "--smoke",
                     "--parallel", "gossip", "--steps", "3", "--batch", "8",
                     "--run-dir", str(tmp_path), "--verify", "--device",
                     "cpu", "--heartbeat-timeout", "30"], env, 150)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "parallel=gossip" in out.stdout and "world=2" in out.stdout
    assert "verify:" in out.stdout and "OK" in out.stdout, out.stdout
