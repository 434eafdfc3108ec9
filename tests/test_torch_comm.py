"""The port's gradient-communication layer (``repro_torch.comm``) against
the JAX package's: the bucket plan, pack/unpack, ``CommConfig`` validation,
the strip-owner layout, and both collective backends on a local mesh.

The reference's backends need G devices: one subprocess with
``--xla_force_host_platform_device_count=4`` (as ``tests/test_distributed``
runs them) computes every backend case of this module once and hands the
results back as numpy.  Tolerances: the ring adds in the same order as the
reference's ring, so f32 agrees bitwise; the plain (``lax``) collectives sum
in another order than XLA, within 1e-6; bf16 wires within 3e-2 (the
reference's own bound between its two backends).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import bucketer as jbucketer  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke_variant  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim.dist import owner_perm as jowner_perm  # noqa: E402
from repro_torch.comm import (  # noqa: E402
    CommConfig,
    LaxBackend,
    RingBackend,
    pack_bucket,
    plan_buckets,
    unpack_buckets,
)
from repro_torch.comm.backends import get_backend  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim.dist import owner_perm  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GS = [1, 2, 3, 4, 8]
BUCKET_BYTES = [0, 64, 1 << 16, 4 * 2 ** 20]
ARCHS = [("vgg-a", False), ("vgg-a", True), ("overfeat-fast", False),
         ("overfeat-fast", True)]


def run_reference(code: str, out_dir, devices: int = 4) -> dict:
    """Run ``code`` in a subprocess with ``devices`` forced host devices;
    it saves its results to ``OUT`` (an npz path), returned as a dict."""
    out = os.path.join(str(out_dir), "reference.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    proc = subprocess.run(
        [sys.executable, "-c", "import repro.jaxcompat\nOUT = "
         f"{out!r}\n" + textwrap.dedent(code)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def _plan_tuple(plan):
    return (plan.group, plan.n_leaves,
            [(b.size, b.padded_size,
              [(s.index, tuple(s.shape), s.size, s.offset, s.dtype)
               for s in b.slots]) for b in plan.buckets])


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("arch,smoke", ARCHS,
                         ids=[f"{a}{'-smoke' if s else ''}" for a, s in ARCHS])
def test_plan_buckets_equals_reference(arch, smoke, G):
    """Full widths plan on meta tensors: no memory is allocated."""
    cfg = get_config(arch)
    cfg = smoke_variant(cfg) if smoke else cfg
    jcfg = jget_config(arch)
    jcfg = jsmoke_variant(jcfg) if smoke else jcfg
    meta = {k: torch.empty(s.shape, device="meta")
            for k, s in cnn.param_specs(cfg).items()}
    shapes = {k: jax.ShapeDtypeStruct(s.shape, jnp.float32)
              for k, s in jcnn.param_specs(jcfg).items()}
    for bb in BUCKET_BYTES:
        got = plan_buckets(meta, G, bb)
        want = jbucketer.plan_buckets(shapes, G, bb)
        assert _plan_tuple(got) == _plan_tuple(want), (arch, G, bb)
        assert got.total_padded == want.total_padded


def test_full_width_vgg_plan_at_g4():
    """The plan the card's zero1 run moves: 22 leaves, 132,863,336 f32
    params in 14 buckets at 4 MiB; fc13_w alone is the largest."""
    meta = {k: torch.empty(s.shape, device="meta")
            for k, s in cnn.param_specs(get_config("vgg-a")).items()}
    plan = plan_buckets(meta, 4, 4 * 2 ** 20)
    assert plan.n_leaves == 22 and plan.n_collectives == 14
    assert plan.total_elements == plan.total_padded == 132_863_336
    assert max(b.padded_size for b in plan.buckets) == 102_760_448


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "c": rng.normal(size=(6,)).astype(np.float32),
            "d": rng.normal(size=(2, 2)).astype(np.float32)}


@pytest.mark.parametrize("bf16_leaf", [False, True])
@pytest.mark.parametrize("bb", [0, 64, 1 << 16])
def test_pack_unpack_equal_reference_and_round_trip(bb, bf16_leaf):
    tree = _mixed_tree(bb)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ttree = {k: torch.tensor(v) for k, v in tree.items()}
    if bf16_leaf:   # a dtype change closes the bucket
        jtree["c"] = jtree["c"].astype(jnp.bfloat16)
        ttree["c"] = torch.tensor(np.asarray(jtree["c"], np.float32)) \
            .bfloat16()
    plan = plan_buckets(ttree, 4, bb)
    jplan = jbucketer.plan_buckets(jtree, 4, bb)
    assert _plan_tuple(plan) == _plan_tuple(jplan)
    leaves, jleaves = tree_leaves(ttree), jax.tree.leaves(jtree)
    bufs = [pack_bucket(leaves, b) for b in plan.buckets]
    jbufs = [jbucketer.pack_bucket(jleaves, b) for b in jplan.buckets]
    for buf, jbuf in zip(bufs, jbufs):
        np.testing.assert_array_equal(buf.float().numpy(),
                                      np.asarray(jbuf, np.float32))
    back = unpack_buckets(bufs, plan)
    for got, want in zip(back, leaves):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("kw", [dict(reduce_dtype="float16"),
                                dict(wire_format="int4"),
                                dict(reduce_dtype="bfloat16",
                                     wire_format="fp32"),
                                dict(reduce_dtype="bfloat16",
                                     wire_format="int8"),
                                dict(topk_ratio=0.0),
                                dict(topk_ratio=1.5),
                                dict(backend="nccl"),
                                dict(cross_backend="ring")])
def test_comm_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        jbucketer.CommConfig(**kw)
    with pytest.raises(ValueError):
        CommConfig(**kw)


@pytest.mark.parametrize("kw", [dict(), dict(reduce_dtype="bfloat16"),
                                dict(wire_format="int8"),
                                dict(wire_format="topk", topk_ratio=0.25),
                                dict(backend="pallas-ring",
                                     cross_backend="gossip")])
def test_comm_config_derives_what_the_reference_derives(kw):
    got, want = CommConfig(**kw), jbucketer.CommConfig(**kw)
    assert got.wire_format == want.wire_format
    assert got.compressed == want.compressed
    assert got.wire_dtype == {"float32": torch.float32,
                              "bfloat16": torch.bfloat16}[
        np.dtype(want.wire_dtype).name]


@pytest.mark.parametrize("hier,sizes", [(False, [4]), (True, [4]),
                                        (True, [2, 2]), (True, [2, 4]),
                                        (True, [4, 2]), (False, [2, 2])])
def test_owner_perm_equals_reference(hier, sizes):
    got, want = owner_perm(hier, sizes), jowner_perm(hier, sizes)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hier,sizes", [(False, [4]), (True, [4]),
                                        (True, [2, 2]), (True, [2, 4]),
                                        (True, [4, 2]), (False, [2, 2])])
def test_owner_layout_is_the_schedules_owner_index(hier, sizes):
    # the strip state's rows (owner_layout) are the strips the schedule
    # hands each member (owner_index), member by member
    from repro_torch.optim import MomentumSGD
    from repro_torch.optim.dist import UpdatePlan
    mesh = make_local_mesh(int(np.prod(sizes)), pods=sizes[0]
                           if len(sizes) == 2 else 1, device="cpu")
    up = UpdatePlan.build(MomentumSGD(), mesh, mesh.axis_names,
                          CommConfig(hierarchical=hier))
    perm = up.owner_layout()
    want = tuple(range(mesh.size)) if perm is None else tuple(perm.tolist())
    assert up.schedule().owner_index() == want


def test_unported_backend_pieces_raise():
    # every registered backend resolves (gossip is ported); the backends
    # still take the schedules' 1-D buffers only, and unknown names raise
    mesh = make_local_mesh(4, device="cpu")
    assert get_backend("gossip").name == "gossip"
    for b in (LaxBackend(), RingBackend(), get_backend("gossip")):
        with pytest.raises(NotImplementedError):
            b.part_reduce(torch.zeros(4, 2, 4), mesh, "data")
    with pytest.raises(ValueError):
        get_backend("nccl")


# ---------------------------------------------------------------------------
# both backends on a local mesh against the reference's on 4 devices
# ---------------------------------------------------------------------------
MESHES = {"data": ((4,), ("data",)), "pod-data": ((2, 2), ("pod", "data"))}
N = 32


def _member_inputs(dt):
    """Per-member partials (4, N) and one replicated buffer (N,)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, N)).astype(np.float32)
    r = rng.normal(size=(N,)).astype(np.float32)
    if dt == "bf16":   # values both packages hold exactly
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        r = np.asarray(jnp.asarray(r, jnp.bfloat16), np.float32)
    return x, r


@pytest.fixture(scope="module")
def reference_backends(tmp_path_factory):
    return run_reference("""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType, PartitionSpec as P
        from repro.comm import LaxBackend, PallasRingBackend
        out = {}
        rng = np.random.default_rng(0)
        xs = rng.normal(size=(4, 32)).astype(np.float32)
        rs = rng.normal(size=(32,)).astype(np.float32)
        for name, shape, axes in (("data", (4,), ("data",)),
                                  ("pod-data", (2, 2), ("pod", "data"))):
            mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:4],
                                 axis_types=(AxisType.Auto,) * len(axes))
            ax = axes if len(axes) > 1 else axes[0]
            for dt, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
                x = jnp.asarray(xs, jdt).reshape(-1)
                r = jnp.asarray(rs, jdt)
                for bname, b in (("lax", LaxBackend()),
                                 ("ring", PallasRingBackend())):
                    def inner(x, b=b):
                        strip = b.part_reduce(x, ax)
                        return strip, b.part_broadcast(strip, ax), \\
                            b.psum(x, ax)
                    for kind, arg, spec in (("members", x, P(ax)),
                                            ("replicated", r, P())):
                        with jax.set_mesh(mesh):
                            res = jax.jit(jax.shard_map(
                                inner, mesh=mesh, in_specs=spec,
                                out_specs=(P(ax), P(ax), P(ax)),
                                check_vma=False))(arg)
                        for what, v in zip(("strips", "full", "psum"), res):
                            out[f"{name}/{dt}/{bname}/{kind}/{what}"] = \\
                                np.asarray(v, np.float32).reshape(4, -1)
        np.savez(OUT, **out)
    """, tmp_path_factory.mktemp("reference_backends"))


@pytest.mark.parametrize("kind", ["members", "replicated"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bname", ["lax", "ring"])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_backends_match_reference_on_a_local_mesh(reference_backends,
                                                  mesh_name, bname, dt,
                                                  kind):
    shape, axes = MESHES[mesh_name]
    mesh = make_local_mesh(4, pods=shape[0] if len(shape) == 2 else 1,
                           device="cpu")
    assert mesh.data_axes == axes and mesh.shape["model"] == 1
    ax = axes if len(axes) > 1 else axes[0]
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    xs, r = _member_inputs(dt)
    x = torch.tensor(xs).to(tdt) if kind == "members" \
        else torch.tensor(r).to(tdt).expand(4, -1)
    b = LaxBackend() if bname == "lax" else RingBackend()
    strip = b.part_reduce(x, mesh, ax)
    got = {"strips": strip, "full": b.part_broadcast(strip, mesh, ax),
           "psum": b.psum(x, mesh, ax)}
    assert got["strips"].shape == (4, N // 4) and strip.dtype == tdt
    for what, v in got.items():
        want = reference_backends[f"{mesh_name}/{dt}/{bname}/{kind}/{what}"]
        v = v.float().numpy()
        if dt == "bf16":
            np.testing.assert_allclose(v, want, rtol=3e-2, atol=3e-2)
        elif bname == "ring":
            np.testing.assert_array_equal(v, want, err_msg=what)
        else:
            np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-6,
                                       err_msg=what)
