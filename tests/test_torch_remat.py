"""Activation checkpointing of the port (``cfg.remat``,
``models.transformer.remat_body``), as the reference wraps its scan body
in ``jax.checkpoint`` (``src/repro/models/transformer.py:249-254``), on
the CPU.

- ``"block"`` and ``"block_dots"``: the loss and every gradient leaf equal
  ``"none"``'s bitwise (a recompute runs the same kernels on the same
  inputs), on dense, sliding-window, MoE, hybrid (zamba2's shared block in
  the body) and xLSTM configs, and under a model axis with
  ``seq_shard_carry``.
- ``FlopCounterMode``: a train step at ``"block"`` counts one more forward
  of the blocks, less each repeat's last product, whose output no gradient
  needs (the non-reentrant checkpoint stops its recompute there, as the
  reference's partial evaluation drops it); at ``"block_dots"`` it counts
  one more of the blocks' batched products alone (the plain ``mm`` outputs
  are saved).
- The §3.1 overlapped zero1 step (its taps fire inside a recompute's
  backward) leaves the same params as at ``"none"``, bitwise.
- Inference (no gradients, or caches) runs no checkpoint.
"""
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.core.sharding import ShardingCtx  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
B, S = 2, 32

CASES = {
    "dense": ("llama3-8b", {}, None),
    "local-softcap": ("gemma2-2b", {}, None),
    "moe": ("qwen2-moe-a2.7b", {}, None),
    "shared-block": ("zamba2-2.7b", {}, None),
    "xlstm": ("xlstm-125m", {}, None),
    "model-axis": ("llama3-8b", {"seq_shard_carry": True}, (2, 2)),
}


def _setup(case):
    arch, over, mesh = CASES[case]
    cfg = smoke_variant(get_config(arch)).replace(**over)
    ctx = ShardingCtx() if mesh is None else ShardingCtx(
        make_local_mesh(mesh[0], model_ways=mesh[1], device="cpu"))
    params = ctx.place(tt.init_params(cfg, 0, "cpu"), tt.param_specs(cfg))
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    return cfg, ctx, params, {"tokens": tokens}


def _step(cfg, ctx, params, batch):
    """Loss, gradients and the FLOPs that ``FlopCounterMode`` counts."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    p = tt.map_tree(lambda _: next(it), params)
    with FlopCounterMode(display=False) as fc:
        loss = tt.lm_loss(p, cfg, ctx, batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss, grads, fc


@pytest.mark.parametrize("remat", ["block", "block_dots"])
@pytest.mark.parametrize("case", list(CASES))
def test_remat_loss_and_gradients_are_bitwise_none(case, remat):
    cfg, ctx, params, batch = _setup(case)
    loss0, g0, _ = _step(cfg, ctx, params, batch)
    loss, g, _ = _step(cfg.replace(remat=remat), ctx, params, batch)
    assert torch.equal(loss, loss0)
    assert len(g) == len(g0)
    for a, b in zip(g, g0):
        assert torch.equal(a, b)


def test_remat_recomputes_one_forward_of_the_blocks():
    cfg, ctx, params, batch = _setup("dense")
    fwd = {}
    for remat in ("none", "block", "block_dots"):
        fwd[remat] = _step(cfg.replace(remat=remat), ctx, params,
                           batch)[2].get_flop_counts()["Global"]
    with FlopCounterMode(display=False) as blocks:
        with torch.no_grad():
            tt.forward(params, cfg, ctx, tokens=batch["tokens"],
                       return_hidden=True)
    blocks = blocks.get_flop_counts()["Global"]
    total = {k: sum(v.values()) for k, v in fwd.items()}
    mm, bmm = torch.ops.aten.mm, torch.ops.aten.bmm
    # each repeat's last product: the MLP's down projection
    last = 2 * B * S * cfg.d_ff * cfg.d_model
    assert total["block"] - total["none"] == \
        sum(blocks.values()) - cfg.pattern_repeats * last
    assert total["block_dots"] - total["none"] == blocks[bmm]
    assert fwd["block_dots"][mm] == fwd["none"][mm]


def test_remat_under_the_overlapped_zero1_step_is_bitwise_none():
    cfg = smoke_variant(get_config("llama3-8b"))
    out = []
    for remat in ("none", "block"):
        spec = RunSpec(arch=cfg.replace(remat=remat), steps=2, batch=4,
                       seq=16, parallel="zero1", grad_clip=0.0,
                       comm=CommConfig(backend="pallas-ring", overlap=True),
                       mesh=MeshSpec(members_per_device=2))
        with compile_run(spec, device="cpu") as run:
            hist = run.fit(log_fn=lambda *_: None)
            out.append(([h["loss"] for h in hist],
                        [p.clone() for p in tree_leaves(run.params)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_inference_runs_no_checkpoint(monkeypatch):
    cfg, ctx, params, batch = _setup("dense")
    cfg = cfg.replace(remat="block")
    calls = []
    real = tt.remat_body
    monkeypatch.setattr(tt, "remat_body",
                        lambda r: calls.append(r) or real(r))
    with torch.no_grad():
        tt.lm_loss(params, cfg, ctx, batch)
    caches = tt.init_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    tt.forward(params, cfg, ctx, tokens=batch["tokens"], caches=caches,
               update_cache=True)
    assert not calls
    tt.lm_loss(params, cfg, ctx, batch)
    assert calls == ["block"]
    with pytest.raises(ValueError, match="remat"):
        tt.lm_loss(params, cfg.replace(remat="layer"), ctx, batch)
