"""The model-ways train steps of the LMs, the model-axis autograd functions
and the LMs on a gloo process mesh, on the CPU, against the JAX package
where it has a counterpart (``tests/test_distributed.py:306-533``, at its
tolerances); the blocks are ``tests/test_torch_lm_blocks_model.py``'s,
whose helpers this file shares.

- The dense LM train step at ``(2, 2)``: loss 2e-3, params rtol 2e-2 atol
  2e-3 (``test_sharded_train_step_matches_single_device``); the EP train step
  (``moe_expert_pad=4``, remat) at ``(2, 4)`` against the reference's TP
  step: loss 3e-3, grad norm 2e-2 (``test_ep_training_end_to_end_matches_tp``).
- mixtral smoke with FSDP under zero1-gspmd at ``MeshSpec(pods=2,
  members_per_device=4, model_ways=2)``: losses within 1e-5 relative of the
  port's serial run (f32 activations), its state specs equal to the
  reference's ``zero1_state_shardings`` on an ``AbstractMesh``.
- ``reduce_from_model``, ``all_to_all_model``, ``pmax`` and
  ``gather_leaf``: forward and gradients exact against their plain
  definitions on a local mesh and over 2 gloo ranks.
- A 4-rank gloo process mesh running llama-100m (smoke, f32 activations,
  momentum SGD) under dp and zero1 at ``{data: 2, model: 2}``, and with
  FSDP under zero1-gspmd at ``{pod: 2, data: 2}`` (a state leaf's data
  axes on two dims), and under dp and zero1 at ``remat="block"``, against
  the local mesh: losses within 1e-5 relative, params within 1e-6 (each
  rank's half batch sums in another order).
"""
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _gloo_ranks import run_ranks  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.core.sharding import to_members  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from test_torch_lm_blocks_model import JCTX, _cfgs, _ctx, _x  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
def _jstep(jc, jp, batch, opt, ctx=JCTX):
    from repro.optim.schedule import constant
    from repro.train import make_train_step
    step = make_train_step(lambda p, b: jt.lm_loss(p, jc, ctx, b), opt,
                           constant(1e-3))
    p1, _, m = jax.jit(step)(jp, opt.init(jp), 0, batch)
    return jax.tree.map(np.asarray, p1), m


def _tstep(tc, tp, batch, ctx, specs):
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.train import make_train_step
    opt = AdamW()
    step = make_train_step(lambda p, b: tt.lm_loss(p, tc, ctx, b), opt,
                           constant(1e-3))
    p1, _, m = step(tp, opt.init(tp), 0, batch)
    return tree_leaves(ctx.full(p1, specs)), m


def test_sharded_train_step_matches_single_device():
    from repro.optim import AdamW as JAdamW
    jc, tc = _cfgs("llama3-8b")
    jp = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(0, jc.vocab_size, (4, 32))
    p1, m1 = _jstep(jc, jp, {"tokens": jnp.asarray(tokens)}, JAdamW())
    ctx = _ctx()
    specs = tt.param_specs(tc)
    got, m2 = _tstep(tc, ctx.place(params_from_numpy(jp, "cpu"), specs),
                     {"tokens": torch.tensor(tokens)}, ctx, specs)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=2e-3)
    for a, b in zip(got, jax.tree.leaves(p1)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=2e-2,
                                   atol=2e-3)


def test_ep_training_end_to_end_matches_tp():
    from repro.optim import AdamW as JAdamW
    jc, tc = _cfgs("mixtral-8x22b", moe_capacity_factor=4.0)
    jp = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(0, jc.vocab_size, (4, 32))
    _, m0 = _jstep(jc, jp, {"tokens": jnp.asarray(tokens)}, JAdamW())

    def pad(path, a):
        ks = jax.tree_util.keystr(path)
        if any(w in ks for w in ["w_gate", "w_up", "w_down"]):
            return np.pad(a, [(0, 0), (0, 4)] + [(0, 0)] * (a.ndim - 2))
        return a
    tc1 = tc.replace(moe_expert_pad=4, remat="block")
    ctx = _ctx(2, 4)
    specs = tt.param_specs(tc1)
    tp = ctx.place(params_from_numpy(
        jax.tree_util.tree_map_with_path(pad, jp), "cpu"), specs)
    seen = []
    real = tmoe.moe_ep_block
    tmoe.moe_ep_block = lambda *a: seen.append(1) or real(*a)
    try:
        _, m1 = _tstep(tc1, tp, {"tokens": torch.tensor(tokens)}, ctx, specs)
    finally:
        tmoe.moe_ep_block = real
    # remat="block" runs every layer's forward once more in the backward
    assert len(seen) == 2 * tc.num_layers
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=3e-3)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m0["grad_norm"]), rtol=2e-2)


def test_fsdp_zero1_gspmd_over_pods_matches_serial(monkeypatch):
    """mixtral with FSDP at ``{pod: 2, data: 2, model: 2}``: a state leaf's
    data axes sit on two dims ("embed_fsdp"'s and the pod's)."""
    from jax.sharding import AbstractMesh

    from repro.api.families import adapter_for as jadapter_for
    from repro.core.sharding import ShardingRules as JRules
    from repro.optim import AdamW as JAdamW
    from repro.train.train_step import zero1_state_shardings
    jc, tc = _cfgs("mixtral-8x22b", fsdp=True)
    monkeypatch.setattr(tt, "ACTIVATION_DTYPE", torch.float32)
    runs = {}
    for par, mesh in (("serial", MeshSpec()),
                      ("zero1-gspmd", MeshSpec(pods=2, members_per_device=4,
                                               model_ways=2))):
        run = compile_run(RunSpec(arch=tc, steps=2, batch=8, seq=32,
                                  parallel=par, mesh=mesh, lr=1e-2,
                                  schedule="constant", log_every=1),
                          device="cpu")
        runs[par] = (run, [h["loss"] for h in run.fit(log_fn=lambda *_: 0)])
    run, losses = runs["zero1-gspmd"]
    assert run.mesh.shape == {"pod": 2, "data": 2, "model": 2}
    np.testing.assert_allclose(losses, runs["serial"][1], rtol=1e-5)
    # the reference's state specs on an AbstractMesh of the same shape: the
    # AdamW moments' (mu, then nu) repeat the param tree
    shapes = jax.eval_shape(lambda: JAdamW().init(jt.init_params(
        jc, jax.random.PRNGKey(0))))
    sh = zero1_state_shardings(
        shapes, jadapter_for(jc).param_axes(jc),
        AbstractMesh((2, 2, 2), ("pod", "data", "model")), JRules())
    want = [tuple(s.spec) for s in jax.tree.leaves(sh.mu)]
    assert [tuple(s) for s in run.dist_update.strip] == want
    assert any(sum(1 for e in s if e and set(
        e if isinstance(e, tuple) else (e,)) & {"pod", "data"}) == 2
        for s in run.dist_update.strip)


# ---------------------------------------------------------------------------
# the model-axis autograd functions
# ---------------------------------------------------------------------------
def test_model_axis_functions_on_a_local_mesh():
    mesh = make_local_mesh(1, model_ways=3, device="cpu")
    xs = [torch.tensor(_x((6, 4), i), requires_grad=True) for i in range(3)]
    y = coll.reduce_from_model(xs, mesh)
    torch.testing.assert_close(y, xs[0] + xs[1] + xs[2], rtol=0, atol=0)
    g = torch.tensor(_x((6, 4), 9))
    for gx in torch.autograd.grad(y, xs, g):
        assert torch.equal(gx, g)
    # all-to-all: member j gets block j of every member's tensor
    out = coll.all_to_all_model(xs, mesh)
    for j in range(3):
        assert torch.equal(out[j], torch.cat([x[2 * j:2 * j + 2]
                                              for x in xs]))
    gs = [torch.tensor(_x((6, 4), 20 + j)) for j in range(3)]
    back = torch.autograd.grad(out, xs, gs)
    for i in range(3):
        assert torch.equal(back[i], torch.cat([g[2 * i:2 * i + 2]
                                               for g in gs]))
    m = coll.pmax([x.detach() for x in xs], mesh)
    assert torch.equal(m, torch.maximum(torch.maximum(xs[0], xs[1]),
                                        xs[2]).detach())
    # gather_leaf: a (M, d, n/M) member layout made whole, its gradient
    # split back
    full = torch.tensor(_x((4, 6), 5))
    w = to_members(full, (None, "model"), mesh).requires_grad_()
    whole = coll.gather_leaf(w, (None, "model"), mesh)
    assert torch.equal(whole, full)
    gw, = torch.autograd.grad((whole * full).sum(), [w])
    assert torch.equal(gw, to_members(full, (None, "model"), mesh))


_FN_WORKER = textwrap.dedent("""
    import sys, torch
    import torch.distributed as dist
    rank, world, init, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    from repro_torch.core import collectives as coll
    from repro_torch.core.sharding import to_members
    from repro_torch.launch.mesh import make_process_mesh
    mesh = make_process_mesh(model_ways=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(6, 4, generator=g) for _ in range(2)]
    x = xs[rank].clone().requires_grad_()
    (y,) = [coll.reduce_from_model([x], mesh)]
    assert torch.equal(y, xs[0] + xs[1])
    (gx,) = torch.autograd.grad(y, [x], torch.ones(6, 4))
    assert torch.equal(gx, torch.ones(6, 4))
    (o,) = coll.all_to_all_model([x], mesh)
    assert torch.equal(o, torch.cat([xs[0][3 * rank:3 * rank + 3],
                                     xs[1][3 * rank:3 * rank + 3]]))
    gs = [torch.randn(6, 4, generator=g) for _ in range(2)]
    (b,) = torch.autograd.grad(o, [x], gs[rank])
    assert torch.equal(b, torch.cat([gs[0][3 * rank:3 * rank + 3],
                                     gs[1][3 * rank:3 * rank + 3]]))
    assert torch.equal(coll.pmax([x.detach()], mesh),
                       torch.maximum(xs[0], xs[1]))
    full = torch.randn(4, 6, generator=g)
    w = to_members(full, (None, "model"), mesh).requires_grad_()
    whole = coll.gather_leaf(w, (None, "model"), mesh)
    assert torch.equal(whole, full)
    (gw,) = torch.autograd.grad((whole * full).sum(), [w])
    assert torch.equal(gw, to_members(full, (None, "model"), mesh))
    print("OK", rank, flush=True)
    dist.barrier()
""")


def test_model_axis_functions_over_two_gloo_ranks(tmp_path):
    run_ranks(_FN_WORKER, 2, tmp_path, SRC)
    for r in range(2):
        assert f"OK {r}" in (tmp_path / f"rank{r}.log").read_text()


_LM_WORKER = textwrap.dedent("""
    import sys, torch
    import torch.distributed as dist
    rank, world, init, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    from repro_torch.api import MeshSpec, RunSpec, compile_run
    from repro_torch.comm import CommConfig
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import transformer
    transformer.ACTIVATION_DTYPE = torch.float32
    q = lambda *_: None
    from repro_torch.configs import get_config, smoke_variant
    base = RunSpec(arch="llama-100m", smoke=True, steps=2, batch=4, seq=32,
                   optimizer="sgd", lr=1e-2, schedule="constant",
                   log_every=1)
    # FSDP at {pod: 2, data: 2}: a zero1-gspmd state leaf's data axes on
    # two dims ("embed_fsdp"'s and the pod's)
    fsdp = smoke_variant(get_config("llama-100m")).replace(fsdp=True)
    remat = smoke_variant(get_config("llama-100m")).replace(remat="block")
    for par, comm, mw, pods, shape in @CASES@:
        mesh = make_process_mesh(pods=pods, model_ways=mw, device="cpu")
        s = base.replace(parallel=par, comm=comm)
        if pods > 1:
            s = s.replace(arch=fsdp, smoke=False)
        if @REMAT@:
            s = s.replace(arch=remat, smoke=False)
        run = compile_run(s, device="cpu", mesh=mesh)
        assert run.cfg.remat == ("block" if @REMAT@ else "none")
        wq = run.params["blocks"][0]["attn"]["wq"]
        assert tuple(wq.shape) == shape, wq.shape
        if pods > 1:
            k = [i for i, sp in enumerate(run.dist_update.strip)
                 if sum(1 for e in sp if e) == 2]
            assert k, run.dist_update.strip
        hist = run.fit(log_fn=q)
        full = run.full_params()
        local = compile_run(s.replace(mesh=MeshSpec(
            pods=pods, members_per_device=4 // mw, model_ways=mw)),
            device="cpu")
        lhist = local.fit(log_fn=q)
        for a, b in zip(torch.utils._pytree.tree_leaves(full),
                        torch.utils._pytree.tree_leaves(
                            local.full_params())):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        for h, l in zip(hist, lhist):
            assert abs(h["loss"] - l["loss"]) <= 1e-5 * l["loss"], (
                par, hist, lhist)
        print("OK", rank, par, flush=True)
    dist.barrier()
""")


_LM_CASES = """(
            ("dp", None, 2, 1, (2, 256, 64)),
            ("zero1", CommConfig(backend="pallas-ring"), 2, 1, (2, 256, 64)),
            ("zero1-gspmd", None, 1, 2, (2, 256, 128)))"""


def test_lm_process_mesh_matches_the_local_mesh(tmp_path):
    worker = _LM_WORKER.replace("@CASES@", _LM_CASES).replace(
        "@REMAT@", "False")
    run_ranks(worker, 4, tmp_path, SRC)
    for r in range(4):
        assert (tmp_path / f"rank{r}.log").read_text().count(f"OK {r}") == 3


def test_lm_process_mesh_at_remat_block_matches_the_local_mesh(tmp_path):
    # remat="block" runs each block's forward again inside the backward, so
    # on a process mesh its model-axis collectives (copy_to_model,
    # reduce_from_model, the vocab-parallel sums) run again, in another
    # order, on every gloo rank; the local mesh runs at "block" too
    cases = """(
            ("dp", None, 2, 1, (2, 256, 64)),
            ("zero1", CommConfig(backend="pallas-ring"), 2, 1, (2, 256, 64)))"""
    worker = _LM_WORKER.replace("@CASES@", cases).replace("@REMAT@", "True")
    run_ranks(worker, 4, tmp_path, SRC)
    for r in range(4):
        assert (tmp_path / f"rank{r}.log").read_text().count(f"OK {r}") == 2

