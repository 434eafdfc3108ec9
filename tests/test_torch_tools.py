"""The port's planning tools against the JAX package's, on the CPU: the
production and host meshes, the abstract inputs (``launch.specs``),
``hybrid.plan``, ``model_flops``, the roofline's ring rule and report, the
collective counter and the counted dry run (``launch.dryrun``).

One reference subprocess, started at module setup with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` (the reference's
production meshes need 256 and 512 devices), lowers and compiles nothing:
for every pair of the 10 assigned archs x 4 input shapes x 2 meshes it
records ``hybrid.plan``'s G, model ways, rules and notes (at the port's
H100 entry on both sides), ``model_flops`` and every abstract leaf's
shape, dtype and partition, or the error the reference gives.  It also
runs the attention block of 6 q / 2 kv heads on a ``{data: 1, model: 4}``
mesh of 4 of its devices under ``jit`` (GSPMD splits ``wq``'s columns
across a head boundary): the port's block, whose q heads do not split,
takes the four projections whole on every member and is held to its
forward and gradients at 1e-5 of each's largest magnitude.

Exact: the plan, the FLOPs and the leaves; the ring cost of each kind;
the counter's ring bytes against the closed form of a smoke dp step at
``{data: 2, model: 2}`` (the gradient all-reduce over the data axis, the
model-axis sums of the forward and the backward, the norm's and the
loss's scalars).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import roofline as jroofline  # noqa: E402
from repro.launch.mesh import (  # noqa: E402
    _divisible_factorization as j_factorization,
)
from repro_torch.configs import (  # noqa: E402
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    get_config,
    smoke_variant,
)
from repro_torch.configs.base import H100_SXM_BF16  # noqa: E402
from repro_torch.core import collectives, hybrid, roofline  # noqa: E402
from repro_torch.core.params import map_tree, tree_leaves  # noqa: E402
from repro_torch.core.sharding import (  # noqa: E402
    ShardingCtx,
    ShardingRules,
    to_members,
)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.optim.dist import GspmdUpdate  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": False, "2x16x16": True}
C1 = dict(num_heads=6, num_kv_heads=2, head_dim=32)

_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import repro  # noqa: F401  (jaxcompat)
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, smoke_variant
from repro.configs.base import HardwareConfig
from repro.core import hybrid
from repro.core.params import init_tree
from repro.core.sharding import ShardingCtx, ShardingRules
from repro.launch import specs as sp
from repro.launch.dryrun import model_flops
from repro.launch.mesh import make_production_mesh
from repro.models import layers as jl

HW = HardwareConfig(**json.loads(sys.argv[1]))
out_path = sys.argv[2]


def norm(e):
    return list(e) if isinstance(e, tuple) else e


def leaves(tree):
    return [[list(l.shape), str(l.dtype), [norm(e) for e in l.sharding.spec]]
            for l in jax.tree.leaves(tree)]


pairs = {}
for mesh_name, multi in (("16x16", False), ("2x16x16", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ASSIGNED_ARCHS:
        for name, shape in INPUT_SHAPES.items():
            cfg = get_config(arch)
            if shape.kind == "train" and cfg.remat == "none":
                cfg = cfg.replace(remat="block")
            rec = {}
            try:
                plan = hybrid.plan(cfg, shape, mesh, HW)
                rec["plan"] = [plan.G, plan.model_ways, plan.G_opt_head,
                               plan.G_opt_ff,
                               {k: norm(v) for k, v in plan.rules.rules.items()},
                               list(plan.notes)]
                rec["flops"] = model_flops(cfg, shape.kind,
                                           shape.global_batch, shape.seq_len)
                rules, long_ctx = plan.rules, name == "long_500k"
                rec["params"] = leaves(sp.abstract_params(cfg, mesh, rules))
                if shape.kind == "decode":
                    rec["inputs"] = leaves(sp.abstract_decode_inputs(
                        cfg, shape, mesh, rules, long_ctx))
                else:
                    rec["inputs"] = leaves(sp.abstract_batch(cfg, shape,
                                                             mesh, rules))
                if shape.kind == "prefill":
                    rec["caches"] = leaves(sp.abstract_caches(
                        cfg, shape, mesh, rules, long_ctx))
            except Exception as e:
                rec = {"error": f"{type(e).__name__}: {e}"}
            pairs[f"{arch}|{name}|{mesh_name}"] = rec

# C1: 6 q / 2 kv heads on a {data: 1, model: 4} mesh of 4 devices
jc = smoke_variant(get_config("llama3-8b")).replace(**json.loads(sys.argv[3]))
specs = jl.attn_specs(jc)
p = jax.tree.map(np.asarray, init_tree(specs, jax.random.PRNGKey(11)))
r = np.random.default_rng(12)
B, S = 2, 16
x = r.normal(size=(B, S, jc.d_model)).astype(np.float32)
w = r.normal(size=(B, S, jc.d_model)).astype(np.float32)
pos = np.broadcast_to(np.arange(S), (B, S))
mesh4 = jax.make_mesh((1, 4), ("data", "model"), devices=jax.devices()[:4],
                      axis_types=(AxisType.Auto,) * 2)
rules = ShardingRules()
ctx = ShardingCtx(mesh4, rules)
placed = {k: jax.device_put(v, rules.sharding(specs[k].axes, v.shape, mesh4))
          for k, v in p.items()}
wq_spec = [norm(e) for e in rules.spec(specs["wq"].axes,
                                       specs["wq"].shape, mesh4)]


def fwd(p, x):
    return jl.attention_block(p, x, jc, ctx, jnp.asarray(pos))[0]


def scalar(p, x):
    return jnp.sum(fwd(p, x).astype(jnp.float32) * w)


y = jax.jit(fwd)(placed, jnp.asarray(x))
gp, gx = jax.jit(jax.grad(scalar, argnums=(0, 1)))(placed, jnp.asarray(x))
arrays = {"x": x, "w": w, "y": np.asarray(y), "gx": np.asarray(gx)}
for k in p:
    arrays["p/" + k] = p[k]
    arrays["g/" + k] = np.asarray(gp[k])
np.savez(out_path + ".npz", **arrays)
json.dump({"pairs": pairs, "wq_spec": wq_spec}, open(out_path + ".json", "w"))
"""


class _Reference:
    def __init__(self, root):
        self.path = os.path.join(root, "tools")
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=512",
                   OMP_NUM_THREADS="1")
        self.log = open(self.path + ".log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE,
             json.dumps(dataclasses.asdict(H100_SXM_BF16)), self.path,
             json.dumps(C1)],
            env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self._got = None

    def get(self):
        if self._got is None:
            rc = self.proc.wait(timeout=900)
            self.log.close()
            assert rc == 0, open(self.path + ".log").read()[-4000:]
            with np.load(self.path + ".npz") as z:
                arrays = dict(z)
            self._got = (arrays, json.load(open(self.path + ".json")))
        return self._got

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """Started with the module's first test, so that the tests that need
    no reference (first in the file) run while it computes."""
    ref = _Reference(str(tmp_path_factory.mktemp("tools_ref")))
    yield ref
    ref.close()


def test_production_meshes_allocate_nothing():
    for multi, shape, n in ((False, {"data": 16, "model": 16}, 256),
                            (True, {"pod": 2, "data": 16, "model": 16}, 512)):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        assert mesh.shape == shape and tmesh.mesh_devices(mesh) == n
        assert mesh.device.type == "meta"
        leaves = tree_leaves(sp.abstract_params(get_config("mixtral-8x22b"),
                                                mesh, ShardingRules()))
        assert all(t.is_meta for t in leaves)


# ---------------------------------------------------------------------------
# the host mesh (tests/test_cluster.py:232) and its factorization
# ---------------------------------------------------------------------------
def test_host_mesh_factorization_and_warning():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mesh = tmesh.make_host_mesh(model_ways=4, devices=6, device="cpu")
    assert len(w) == 1, [str(x.message) for x in w]
    msg = str(w[0].message)
    assert "drop 2" in msg and "model_ways=3" in msg, msg
    assert tmesh.mesh_devices(mesh) == 6
    assert mesh.shape == {"data": 2, "model": 3}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tmesh.make_host_mesh(2, 2, devices=8, device="cpu").shape \
            == {"pod": 2, "data": 2, "model": 2}
        assert tmesh.make_host_mesh(device="cpu").shape == \
            {"data": 1, "model": 1}
    for n in range(1, 13):
        for mw in range(1, 9):
            for pods in range(1, 4):
                assert tmesh._divisible_factorization(n, mw, pods) == \
                    j_factorization(n, mw, pods)


# ---------------------------------------------------------------------------
# the roofline (tests/test_roofline.py's counterparts)
# ---------------------------------------------------------------------------
HLO = {
    "all-reduce": ("%ar = f32[1024,512]{1,0} all-reduce(%x), "
                   "replica_groups=[16,16]<=[256]", 1024 * 512 * 4, 16),
    "all-gather": ("%ag = bf16[4096]{0} all-gather(%y), "
                   "replica_groups=[16,16]<=[256]", 4096 * 2, 16),
    "reduce-scatter": ("%rs = f32[128,128]{1,0} reduce-scatter(%z), "
                       "replica_groups=[1,256]<=[256]", 128 * 128 * 4, 256),
    "all-to-all": ("%a2a = f32[64]{0} all-to-all(%w), "
                   "replica_groups=[16,16]<=[256]", 64 * 4, 16),
    "collective-permute": ("%cp = f32[32,32]{1,0} collective-permute(%v), "
                           "source_target_pairs={{0,1}}", 32 * 32 * 4, 2),
}


@pytest.mark.parametrize("kind", list(HLO))
def test_ring_rule_per_kind_is_the_references(kind):
    line, nbytes, group = HLO[kind]
    want = jroofline.parse_collectives(line).ring_bytes
    assert roofline.ring_cost(kind, nbytes, group) == pytest.approx(want)
    st = roofline.CollectiveStats()
    st.add(kind, nbytes, group)
    assert st.count_by_kind == {kind: 1}
    assert st.bytes_by_kind == {kind: nbytes}


def test_report_terms_dominant_and_mfu_at_the_h100_peak():
    st = roofline.CollectiveStats()
    st.add("all-reduce", 1e9, 16)
    rep = roofline.analyze("a", "s", "16x16", 256, 1e15, 1e11, st,
                           model_flops_total=2.56e17)
    assert rep.compute_s == pytest.approx(1e15 / 989.4e12)
    assert rep.memory_s == pytest.approx(1e11 / 3.35e12)
    assert rep.collective_s == pytest.approx(2 * 15 / 16 * 1e9 / 450e9)
    assert rep.dominant == "compute"
    assert rep.useful_flops_ratio == pytest.approx(1.0)
    assert rep.mfu == pytest.approx(1.0)      # the reference's 197e12: 5.02
    row = rep.row()
    assert set(row) == set(jroofline.RooflineReport(
        "a", "s", "m", 1, 0, 0, jroofline.CollectiveStats(), 0, 0, 0, 0
    ).row()) - {"mem_per_dev_gb"} | {"mem_state_per_dev_gb"}
    assert row["coll_counts"] == {"all-reduce": 1}


def test_byte_counter_rule():
    a = torch.ones(64, 32, device="meta")
    b = torch.ones(32, 16, device="meta")
    with roofline.ByteCounter() as c:
        v = a.view(32, 64)                    # a view: nothing
        torch.empty(1000, device="meta")      # an allocation: nothing
        y = a @ b                             # reads a, b, writes y
    assert v.shape == (32, 64)
    assert c.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 == y.numel() * 4 + \
        (64 * 32 + 32 * 16) * 4


# ---------------------------------------------------------------------------
# the collective counter: a smoke dp step's closed form
# ---------------------------------------------------------------------------
def test_counter_on_a_smoke_dp_step_is_the_closed_form():
    cfg = smoke_variant(get_config("llama3-8b"))
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=16,
                                global_batch=4)
    mesh = tmesh.LocalMesh(2, model_ways=2, device="meta")
    rules = ShardingRules()
    # the dry run's member program (dryrun.count_step) with dp's update
    view = tmesh.ProcessMesh.member_view(mesh.shape)
    ctx = ShardingCtx(view, rules)
    specs = tt.param_specs(cfg)
    params = ctx.place(sp.abstract_params(cfg, mesh, rules), specs)
    batch = {"tokens": to_members(sp.abstract_batch(
        cfg, shape, mesh, rules)["tokens"], ("data",), view)}
    opt = AdamW()
    up = GspmdUpdate(opt, view, ctx, specs, zero1=False)
    step = make_train_step(lambda p, b: tt.lm_loss(p, cfg, ctx, b), opt,
                           constant(1e-3), dist_update=up)
    state = up.init_fn(params)
    with collectives.count_collectives() as coll:
        step(params, state, 0, batch)
    # per member: b rows of S tokens; every leaf of llama's smoke blocks
    # splits over the 2 model ways (4 q and 4 kv heads, ff and vocab 512)
    b, S, d, V, R = 2, 16, cfg.d_model, cfg.vocab_size, cfg.num_layers
    act = b * S * d
    model = {
        # forward: the partial sums of the embedding and of every block's
        # attention and MLP (f32), the head's logits gathered (bf16)
        "all-reduce": (1 + 2 * R) * act * 4
        # backward: the input gradients of every members() call (bf16):
        # 2 a layer and the head's
        + (2 * R + 1) * act * 2,
        "all-gather": b * S * V * 2,
    }
    grads = sum(t.numel() * 4 for t in tree_leaves(ctx.place(
        sp.abstract_params(cfg, mesh, rules), tt.param_specs(cfg))))
    # the dp mean over the 2 data members, the norm over all 4, the loss
    want_ring = (model["all-reduce"] + model["all-gather"] / 2 + grads
                 + 2 * 3 / 4 * 4 + 4)
    assert coll.bytes_by_kind["all-gather"] == model["all-gather"]
    assert coll.bytes_by_kind["all-reduce"] == \
        model["all-reduce"] + grads + 4 + 4
    assert coll.ring_bytes == pytest.approx(want_ring, rel=1e-12)
    assert set(coll.count_by_kind) == {"all-reduce", "all-gather"}


def test_counter_costs_nothing_when_inactive_and_nests():
    assert collectives._counter is None
    with collectives.count_collectives() as outer:
        collectives.dist_call("all-reduce", torch.ones(4, device="meta"), 2,
                          None)
        with collectives.count_collectives() as inner:
            collectives.dist_call("all-gather", torch.ones(8, device="meta"),
                              4, None)
        assert inner.count_by_kind == {"all-gather": 1}
    assert outer.count_by_kind == {"all-reduce": 1}
    assert collectives._counter is None


def test_member_zero_is_the_busiest():
    cfg = smoke_variant(get_config("gemma-2b"))
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=16,
                                global_batch=4)
    mesh = tmesh.LocalMesh(2, model_ways=2, device="meta")
    # member 3 sits at coordinate 1 on both axes, member 0 at 0
    counts = [dryrun.count_step(cfg.replace(remat="block"), shape, mesh,
                                ShardingRules(), member=m) for m in (0, 3)]
    assert counts[0][0] == counts[1][0]                # the same FLOPs
    assert counts[0][1] > counts[1][1]                 # the most bytes
    assert counts[0][2].ring_bytes == counts[1][2].ring_bytes


# ---------------------------------------------------------------------------
# the dry run at full width
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma-2b", "musicgen-medium",
                                  "qwen2-vl-2b"])
def test_q_heads_that_do_not_split_are_counted_at_16_ways(arch):
    """(gemma2-2b's 8 heads: the train pair below.)"""
    cfg = get_config(arch)
    assert cfg.num_heads % 16 and cfg.q_dim % 16 == 0
    row = dryrun.count_pair(arch, "decode_32k", False, verbose=False)
    assert row["plan_model_ways"] == 16
    assert 0 < row["useful_ratio"] <= 1.05
    assert row["flops_per_dev"] > 0 and row["coll_ring_bytes"] > 0


def test_a_full_width_train_pair_is_counted_within_budget(tmp_path):
    row = dryrun.run_one("gemma2-2b", "train_4k", False, force=True,
                         out_dir=str(tmp_path))
    assert row["status"] == "ok", row
    assert row["t_count_s"] < 60
    assert 0 < row["useful_ratio"] <= 1.05
    assert row["plan_G"] == 16 and row["plan_model_ways"] == 16
    # remat="block" forced: the count holds a forward more than 3 of them
    assert row["flops_per_dev"] * 256 > row["model_flops"]
    for key in ("compute_s", "memory_s", "collective_s", "mfu",
                "mem_state_per_dev_gb", "coll_counts", "dominant"):
        assert key in row
    saved = json.load(open(tmp_path / "gemma2-2b__train_4k__16x16.json"))
    assert saved["status"] == "ok" and saved["dominant"] == row["dominant"]


# ---------------------------------------------------------------------------
# plan, model FLOPs and abstract inputs: every pair, exact
# ---------------------------------------------------------------------------
def _norm(e):
    return list(e) if isinstance(e, tuple) else e


def _flat(tree):
    """Leaves in the reference's ``jax.tree.leaves`` order: dict keys
    sorted, dataclass fields in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _flat(getattr(tree, f.name))]
    return [t for x in tree for t in _flat(x)]


def _leaves(tree):
    return [[list(t.shape), str(t.dtype).replace("torch.", ""),
             [_norm(e) for e in t.sharding]] for t in _flat(tree)]


def _port_pair(arch, shape_name, multi):
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    if shape.kind == "train" and cfg.remat == "none":
        cfg = cfg.replace(remat="block")
    plan = hybrid.plan(cfg, shape, mesh, H100_SXM_BF16)
    rec = {"plan": [plan.G, plan.model_ways, plan.G_opt_head, plan.G_opt_ff,
                    {k: _norm(v) for k, v in plan.rules.rules.items()},
                    list(plan.notes)],
           "flops": dryrun.model_flops(cfg, shape.kind, shape.global_batch,
                                       shape.seq_len)}
    rules, long_ctx = plan.rules, shape_name == "long_500k"
    rec["params"] = _leaves(sp.abstract_params(cfg, mesh, rules))
    if shape.kind == "decode":
        rec["inputs"] = _leaves(sp.abstract_decode_inputs(
            cfg, shape, mesh, rules, long_ctx))
    else:
        rec["inputs"] = _leaves(sp.abstract_batch(cfg, shape, mesh, rules))
    if shape.kind == "prefill":
        rec["caches"] = _leaves(sp.abstract_caches(cfg, shape, mesh, rules,
                                                   long_ctx))
    return rec


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_plan_flops_and_abstract_inputs_are_the_reference(reference, arch,
                                                          shape, mesh):
    want = reference.get()[1]["pairs"][f"{arch}|{shape}|{mesh}"]
    if "error" in want:          # the same refusal as the reference's
        with pytest.raises(Exception) as e:
            _port_pair(arch, shape, MESHES[mesh])
        assert f"{type(e.value).__name__}: {e.value}" == want["error"]
        return
    got = json.loads(json.dumps(_port_pair(arch, shape, MESHES[mesh])))
    for key in ("plan", "flops", "params", "inputs", "caches"):
        assert got.get(key) == want.get(key), key


# ---------------------------------------------------------------------------
# C1: q heads that do not split, against the reference on 4 devices
# ---------------------------------------------------------------------------
def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_attention_with_q_heads_that_do_not_split_is_the_reference(
        reference):
    arrays, meta = reference.get()
    tc = smoke_variant(get_config("llama3-8b")).replace(**C1)
    specs = tl.attn_specs(tc)
    mesh = tmesh.make_local_mesh(1, model_ways=4, device="cpu")
    ctx = ShardingCtx(mesh, ShardingRules())
    # the reference splits wq's 192 columns 4 ways, across a head boundary
    assert meta["wq_spec"] == [None, "model"] and tc.num_heads % 4
    assert ctx.sharded(specs["wq"])
    p = params_from_numpy({k: arrays["p/" + k] for k in specs}, "cpu")
    tp = ctx.place(p, specs)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    x = torch.tensor(arrays["x"], requires_grad=True)
    S = x.shape[1]
    pos = torch.arange(S).expand(x.shape[0], S)
    y, _ = tl.attention_block(tp, x, tc, ctx, pos)
    _close(y.detach().numpy(), arrays["y"])
    g = torch.autograd.grad((y.float() * torch.tensor(arrays["w"])).sum(),
                            [x] + leaves)
    _close(g[0].numpy(), arrays["gx"])
    it = iter(g[1:])
    full = ctx.full(map_tree(lambda _: next(it), tp), specs)
    for k in specs:
        _close(full[k].numpy(), arrays["g/" + k])
