"""The port's sharding rules, meshes and model-axis collectives
(``repro_torch.core.sharding``, ``launch.mesh``, ``core.collectives``)
against the JAX package's, on the CPU.

- ``ShardingRules.spec`` equals ``tuple(P)`` of the reference's for every
  leaf of every family's ``param_specs`` on the meshes (16, 16), (2, 16,
  16), (2, 2) and (4, 2) (the reference on an ``AbstractMesh``, as its own
  ``tests/test_sharding.py`` runs it, the port on a stand-in with the same
  ``axis_names`` and ``shape``), and the cases of ``tests/test_sharding.py``
  hold in the port.  Exact: the resolver is integer arithmetic.
- ``zero1_state_shardings`` gives the reference's specs for cd-dnn, vgg-a
  and llama-100m on (2, 2), (4, 2) and (2, 2, 2) meshes (the reference in
  one subprocess on 8 forced host devices: its ``NamedSharding`` needs
  real devices).  Exact.
- ``_divisible_factorization`` equals the reference's over n <= 16 and
  model_ways, pods <= 8; ``fit_world`` warns where the reference's
  ``make_host_mesh`` warns.
- The member layouts round-trip exactly, and block (d, m) of a local mesh
  is the slice the reference's tuple entries give it.
- ``copy_to_model`` and ``gather_model`` against a serial product: forward
  and gradients on a local mesh within 1e-6 relative (the same f32 sums
  split into two column blocks, and the input gradient a sum of two partial
  products), and on a 2-rank gloo mesh likewise.
"""
import os
import subprocess
import sys
import textwrap
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _gloo_ranks import run_ranks  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.api.families import adapter_for as jadapter_for  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.params import Spec as JSpec  # noqa: E402
from repro.core.sharding import ShardingRules as JRules  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.api.families import adapter_for  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.core.collectives import copy_to_model, gather_model  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.core.sharding import (  # noqa: E402
    DEFAULT_RULES,
    ShardingCtx,
    ShardingRules,
    block_index,
    from_members,
    held_spec,
    to_members,
)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.train.train_step import zero1_state_shardings  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 shape=dict(zip(axes, shape)))


def _jleaves(arch):
    cfg = jget_config(arch)
    import jax
    return jax.tree.leaves(jadapter_for(cfg).param_specs(cfg),
                           is_leaf=lambda x: isinstance(x, JSpec))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_resolve_as_the_reference(arch, mesh):
    shape, axes = MESHES[mesh]
    jm, tm = AbstractMesh(shape, axes), stand_in(shape, axes)
    cfg = get_config(arch)
    got = tree_leaves(adapter_for(cfg).param_specs(cfg))
    want = _jleaves(arch)
    assert len(got) == len(want) > 0
    jr, tr = JRules(), ShardingRules()
    for g, w in zip(got, want):
        assert (g.shape, g.axes) == (tuple(w.shape), tuple(w.axes))
        assert tr.spec(g.axes, g.shape, tm) == tuple(
            jr.spec(w.axes, w.shape, jm))


def test_rules_and_overrides_are_the_reference():
    assert DEFAULT_RULES == JRules().rules
    over = dict(embed=("data",), cache_seq=("model",), batch=None)
    assert ShardingRules().with_overrides(**over).rules \
        == JRules().with_overrides(**over).rules


# the cases of tests/test_sharding.py, in the port
MESH = stand_in((16, 16), ("data", "model"))
MESH3 = stand_in((2, 16, 16), ("pod", "data", "model"))


def test_divisible_dims_shard():
    assert ShardingRules().spec(("embed", "ff"), (2048, 16384), MESH) \
        == tuple(P(None, "model"))


def test_indivisible_dims_stay_replicated():
    spec = ShardingRules().spec(("experts", "embed", "moe_ff"),
                                (60, 2048, 1408), MESH)
    assert spec == tuple(P(None, None, "model"))


def test_batch_spans_pod_and_data():
    spec = ShardingRules().spec(("batch", "seq"), (256, 4096), MESH3)
    assert spec == tuple(P(("pod", "data")))


def test_no_axis_used_twice():
    spec = ShardingRules().spec(("ff", "moe_ff"), (1600, 3200), MESH)
    used = [s for s in spec if s is not None]
    assert len(used) == len(set(used)) <= 1


@given(dim=st.integers(1, 4096))
@settings(max_examples=60, deadline=None)
def test_resolver_never_breaks_divisibility(dim):
    spec = ShardingRules().spec(("ff",), (dim,), MESH)
    if spec and spec[0] is not None:
        assert dim % 16 == 0
    assert spec == tuple(JRules().spec(("ff",), (dim,),
                                       AbstractMesh((16, 16),
                                                    ("data", "model"))))


def test_held_spec_keeps_the_model_axis_only():
    assert held_spec(("data", "model")) == (None, "model")
    assert held_spec((("pod", "data"), None)) == ()
    assert held_spec((None, None, None, "model")) == (None, None, None,
                                                      "model")


@pytest.mark.parametrize("n", range(1, 17))
def test_divisible_factorization_is_the_reference(n):
    for mw in range(1, 9):
        for pods in range(1, 9):
            assert tmesh._divisible_factorization(n, mw, pods) \
                == jmesh._divisible_factorization(n, mw, pods)


@pytest.mark.parametrize("n,mw,pods,want", [
    (6, 4, 1, (3, 1)), (8, 2, 2, (2, 2)), (6, 2, 2, (2, 1)),
    (16, 8, 8, (8, 2)), (5, 2, 1, (1, 1))])
def test_fit_world_clamps_and_warns_as_make_host_mesh(n, mw, pods, want):
    divides = n % (max(1, min(mw, n)) * max(1, min(pods, n // max(1, min(
        mw, n))))) == 0
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tmesh.fit_world(n, mw, pods) == want
    assert bool(w) == (not divides)
    if w:
        assert "largest divisible factorization" in str(w[0].message)


def test_local_mesh_has_the_reference_axes():
    m = make_local_mesh(2, model_ways=2, device="cpu")
    assert m.axis_names == ("data", "model") and m.size == 4
    assert (m.data_axes, m.data_size, m.model_ways) == (("data",), 2, 2)
    assert [m.coords(i) for i in range(4)] == [
        {"data": d, "model": k} for d in range(2) for k in range(2)]
    v = m.data_view()
    assert v.shape == {"data": 2, "model": 1} and v.size == 2
    m3 = make_local_mesh(4, pods=2, model_ways=2, device="cpu")
    assert m3.shape == {"pod": 2, "data": 2, "model": 2}
    assert m3.data_view().shape == {"pod": 2, "data": 2, "model": 1}
    one = make_local_mesh(4, device="cpu")
    assert one.shape == {"data": 4, "model": 1} and one.data_view() is one


@pytest.mark.parametrize("spec", [(None, "model"), ("data", "model"),
                                  (None, None, "data", "model"), ("model",),
                                  (("pod", "data"), "model"), ()])
def test_member_layouts_round_trip_and_match_the_slices(spec):
    mesh = make_local_mesh(4, pods=2, model_ways=2, device="cpu")
    rank = max(len(spec), 2)
    shape = tuple(4 * (i + 2) for i in range(rank))
    full = torch.arange(float(np.prod(shape))).reshape(shape)
    held = to_members(full, spec, mesh)
    assert torch.equal(from_members(held, spec, mesh), full)
    used = [a for a in mesh.axis_names
            if any(a in (e if isinstance(e, tuple) else (e,)) for e in spec)]
    if not used:
        assert held is full
        return
    for member in range(mesh.size):
        c = mesh.coords(member)
        idx = block_index(spec, mesh, member)
        sl = []
        for d, dim in enumerate(shape):
            e = spec[d] if d < len(spec) else None
            n = int(np.prod([mesh.shape[a] for a in
                             (e if isinstance(e, tuple) else (e,))
                             if a is not None])) if e else 1
            sl.append(slice(idx[d] * dim // n, (idx[d] + 1) * dim // n)
                      if d < len(idx) else slice(None))
        block = held[tuple(c[a] for a in used)]
        assert block.is_contiguous()
        assert torch.equal(block, full[tuple(sl)])


def test_ctx_is_a_no_op_without_model_ways():
    cfg = get_config("cd-dnn")
    specs = adapter_for(cfg).param_specs(cfg)
    tree = {k: torch.ones(s.shape) for k, s in specs.items()}
    for ctx in (ShardingCtx(), ShardingCtx(make_local_mesh(4,
                                                           device="cpu"))):
        assert ctx.place(tree, specs) is tree
        assert ctx.full(tree, specs) is tree
        assert not any(ctx.sharded(s) for s in specs.values())


def test_column_refuses_a_half_sharded_layer():
    from repro_torch.core.params import Spec
    ctx = ShardingCtx(make_local_mesh(1, model_ways=2, device="cpu"))
    w, b = Spec((4, 6), ("embed", "ff")), Spec((6,), ("embed",))
    with pytest.raises(ValueError, match="every leaf on the model axis"):
        ctx.column(torch.ones(2, 4), [torch.ones(2, 4, 3), torch.ones(6)],
                   [w, b], lambda x, w, b: x @ w + b)


def _serial_and_sharded(mesh_members, x, W, b):
    mesh = make_local_mesh(mesh_members, model_ways=2, device="cpu")
    ws = to_members(W, (None, "model"), mesh).requires_grad_()
    bs = to_members(b, ("model",), mesh).requires_grad_()
    xs = x.clone().requires_grad_()
    outs = [xi @ wi + bi for xi, wi, bi in zip(copy_to_model(xs, mesh),
                                                ws.unbind(0), bs.unbind(0))]
    y = gather_model(outs, mesh)
    return mesh, xs, ws, bs, y


def test_model_axis_functions_on_a_local_mesh():
    g = torch.Generator().manual_seed(0)
    x, W, b = (torch.randn(5, 8, generator=g), torch.randn(8, 6, generator=g),
               torch.randn(6, generator=g))
    cot = torch.randn(5, 6, generator=g)
    mesh, xs, ws, bs, y = _serial_and_sharded(1, x, W, b)
    xr, Wr, br = (t.clone().requires_grad_() for t in (x, W, b))
    yr = xr @ Wr + br
    torch.testing.assert_close(y, yr, rtol=1e-6, atol=1e-6)
    (y * cot).sum().backward()
    (yr * cot).sum().backward()
    torch.testing.assert_close(xs.grad, xr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(from_members(ws.grad, (None, "model"), mesh),
                               Wr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(from_members(bs.grad, ("model",), mesh),
                               br.grad, rtol=1e-6, atol=1e-6)


_GLOO_WORKER = textwrap.dedent("""
    import sys, torch
    import torch.distributed as dist
    rank, world, init, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    from repro_torch.core.collectives import copy_to_model, gather_model
    from repro_torch.core.sharding import from_members, to_members
    from repro_torch.launch.mesh import make_process_mesh
    mesh = make_process_mesh(model_ways=2, device="cpu")
    assert mesh.shape == {"data": 1, "model": 2}, mesh
    assert mesh.batch_shard == (0, 1) and mesh.data_view().size == 1
    g = torch.Generator().manual_seed(0)
    x, W, b = (torch.randn(5, 8, generator=g), torch.randn(8, 6, generator=g),
               torch.randn(6, generator=g))
    cot = torch.randn(5, 6, generator=g)
    w = to_members(W, (None, "model"), mesh).requires_grad_()
    bb = to_members(b, ("model",), mesh).requires_grad_()
    assert torch.equal(w, W[:, 3 * rank:3 * rank + 3])
    xs = x.clone().requires_grad_()
    (xi,) = copy_to_model(xs, mesh)
    y = gather_model([xi @ w + bb], mesh)
    xr, Wr, br = (t.clone().requires_grad_() for t in (x, W, b))
    yr = xr @ Wr + br
    torch.testing.assert_close(y, yr, rtol=1e-6, atol=1e-6)
    (y * cot).sum().backward()
    (yr * cot).sum().backward()
    torch.testing.assert_close(xs.grad, xr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(w.grad, Wr.grad[:, 3 * rank:3 * rank + 3],
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(from_members(w.grad, (None, "model"), mesh),
                               Wr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bb.grad, br.grad[3 * rank:3 * rank + 3],
                               rtol=1e-6, atol=1e-6)
    dist.barrier()
    print("OK", rank)
""")


def test_model_axis_functions_over_two_gloo_ranks(tmp_path):
    run_ranks(_GLOO_WORKER, 2, tmp_path, SRC)
    for r in range(2):
        assert f"OK {r}" in (tmp_path / f"rank{r}.log").read_text()


# ---------------------------------------------------------------------------
# zero1_state_shardings against the reference on real (forced) devices
# ---------------------------------------------------------------------------
STATE_MESHES = [((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
                ((2, 2, 2), ("pod", "data", "model"))]
STATE_ARCHS = ("cd-dnn", "vgg-a", "llama-100m")


@pytest.fixture(scope="module")
def reference_state_specs(tmp_path_factory):
    """The reference's zero1_state_shardings for STATE_ARCHS x STATE_MESHES
    (full configs, shapes only), on 8 forced host devices."""
    out = os.path.join(str(tmp_path_factory.mktemp("z1spec")), "specs.txt")
    code = textwrap.dedent(f"""
        import repro.jaxcompat
        import jax
        from jax.sharding import AxisType
        from repro.api.families import adapter_for
        from repro.configs import get_config
        from repro.core.sharding import ShardingRules
        from repro.optim import AdamW, MomentumSGD
        from repro.train import zero1_state_shardings
        lines = []
        for arch in {STATE_ARCHS!r}:
            cfg = get_config(arch)
            fam = adapter_for(cfg)
            shapes = jax.eval_shape(
                lambda: fam.init(cfg, jax.random.PRNGKey(0)))
            for shape, axes in {STATE_MESHES!r}:
                n = 1
                for s in shape:
                    n *= s
                mesh = jax.make_mesh(shape, axes,
                                     devices=jax.devices()[:n],
                                     axis_types=(AxisType.Auto,) * len(axes))
                for opt in (MomentumSGD(), AdamW()):
                    st = jax.eval_shape(opt.init, shapes)
                    sh = zero1_state_shardings(st, fam.param_axes(cfg), mesh,
                                               ShardingRules())
                    specs = [tuple(s.spec) for s in jax.tree.leaves(sh)]
                    lines.append(repr((arch, shape, type(opt).__name__,
                                       specs)))
        open({out!r}, "w").write("\\n".join(lines))
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    import ast
    return {(a, s, o): specs for a, s, o, specs in
            map(ast.literal_eval, open(out).read().splitlines())}


class _Shape:
    """A state leaf's stand-in: its ndim and shape."""

    def __init__(self, shape):
        self.shape, self.ndim = tuple(shape), len(shape)


def _spec_leaves(tree):
    """The spec tuples of a ``zero1_state_shardings`` tree, in leaf order
    (a plain tuple is a leaf; NamedTuples, dicts and lists are walked)."""
    if isinstance(tree, tuple) and all(
            e is None or isinstance(e, str) or (
                isinstance(e, tuple) and all(isinstance(a, str) for a in e))
            for e in tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for t in tree for x in _spec_leaves(t)]


@pytest.mark.parametrize("opt", ["MomentumSGD", "AdamW"])
@pytest.mark.parametrize("mesh", range(len(STATE_MESHES)))
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_zero1_state_shardings_are_the_reference(reference_state_specs,
                                                 arch, mesh, opt):
    from repro_torch.core.params import map_tree
    from repro_torch.optim import AdamWState, SgdState
    shape, axes = STATE_MESHES[mesh]
    cfg = get_config(arch)
    fam = adapter_for(cfg)
    shapes = map_tree(lambda s: _Shape(s.shape), fam.param_specs(cfg))
    state = AdamWState(count=0, mu=shapes, nu=shapes) if opt == "AdamW" \
        else SgdState(velocity=shapes)
    got = zero1_state_shardings(state, fam.param_axes(cfg),
                                stand_in(shape, axes))
    want = reference_state_specs[(arch, shape, opt)]
    assert _spec_leaves(got) == [tuple(s) for s in want]
    if opt == "MomentumSGD" and shape == (2, 2):
        # the placements the reference's GSPMD run makes: a weight's
        # momentum takes the data strip beside its model columns, a bias's
        # one dim is taken, so it keeps none
        v = got.velocity
        if arch == "cd-dnn":
            assert v["fc00_w"] == ("data", "model")
            assert v["fc00_b"] == ("model",)
        if arch == "vgg-a":
            assert v["conv02_w"] == (None, None, "data", "model")
