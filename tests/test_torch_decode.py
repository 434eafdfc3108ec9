"""The port's dense ring-buffer decode (``serve.decode``) and the slice's
configs against the JAX package, on the CPU.

- ``kernels.ref.decode_attention_ref`` against the reference's, f32 and
  bf16, GQA and MQA, softcap, ragged valid lengths;
- ``prefill`` and ``decode_step``: the logits and the ring buffers, the
  decode steps teacher-forced with the reference's tokens, through a wrap
  of the sliding-window ring;
- ``generate`` (greedy) against the reference's ``generate``, over a ring
  wrap, for dense and MoE archs; sampling from a seeded generator;
- every field of the five configs this slice adds.

Params are the reference's (``jax.random`` init) carried over as numpy;
prompts come from numpy seeds.

Tolerances:
- ``decode_attention_ref``: f32 1e-5 (the same f32 terms summed in other
  orders); bf16 one ulp at the output's largest magnitude (both compute in
  f32 and round once).
- logits: 4 bf16 ulps at their largest magnitude, mean 0.75 of an ulp,
  and the k/v rows the caches hold the same (bf16 activations round at
  other places in the two frameworks).  Measured: max 2.5, mean up to 0.52
  (h2o-danube's smoke config, whose whole-sequence forward alone parts by
  a mean 0.44; ``tests/test_torch_serve.py`` holds its archs' paged steps
  to a mean of 0.5), the other dense archs at most 0.43.  For the
  MoE arch a near-tied router choice can be broken differently and
  reroute a token; its logits are then compared only where every layer's
  choice agreed, and the disagreements must sit at margins within twice
  the one-ulp sensitivity (``tests/test_torch_moe.py``).
- greedy tokens: the first token where the packages part must be a step
  where the reference's top-2 margin is within twice the largest logit
  difference (of the teacher-forced sequence); at least 75% of the tokens
  must be compared before any parting.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core.sharding import ShardingCtx  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro_torch.configs import ARCHS, ModelConfig, get_config  # noqa: E402
from repro_torch.core.sharding import ShardingCtx as TShardingCtx  # noqa: E402,E501
from repro_torch.configs import smoke_variant  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import paged_attn  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve import decode as tdecode  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
CTX = ShardingCtx()
TCTX = TShardingCtx()
MAX_ULPS, MEAN_ULPS = 4, 0.75
NEW_ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b", "gemma-2b",
             "h2o-danube-3-4b", "llama-100m"]
# (arch, overrides): a window of 16 < prompt + new tokens wraps the local
# rings (gemma2's alternating layers, h2o-danube's and mixtral's all-local
# stacks); gemma-2b is MQA, qwen2-moe has shared experts
GEN_CASES = [
    ("gemma2-2b", {"sliding_window": 16}),
    ("h2o-danube-3-4b", {"sliding_window": 16}),
    ("gemma-2b", {}),
    ("llama-100m", {}),
    ("qwen2-moe-a2.7b", {}),
    ("mixtral-8x22b", {"sliding_window": 16}),
]
GEN_IDS = ["-".join([a] + [f"{k}{v}" for k, v in o.items()])
           for a, o in GEN_CASES]


def _ulp(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _assert_bf16_close(got, want, what):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    d = d / _ulp(np.asarray(want, np.float32))
    assert d.max() <= MAX_ULPS and d.mean() <= MEAN_ULPS, \
        (what, d.max(), d.mean())


def _models(arch, over, seed=0):
    jc = jsmoke(jget_config(arch)).replace(**over)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = jt.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# the ring-buffer attention oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 4, 32), (8, 2, 64), (8, 1, 120)])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_ref_matches_reference(Hq, Hkv, D, softcap, dtype):
    rng = np.random.default_rng(Hq + D)
    B, C = 3, 24
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    ln = np.array([1, 13, C], np.int32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(ln), window=16, logit_softcap=softcap), np.float32)
    got = tref.decode_attention_ref(
        torch.tensor(q).to(tdt), torch.tensor(k).to(tdt),
        torch.tensor(v).to(tdt), torch.tensor(ln), window=16,
        logit_softcap=softcap).float().numpy()
    assert got.shape == want.shape == (B, 1, Hq, D)
    atol = 1e-5 if dtype == "f32" else _ulp(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# prefill + decode_step, teacher-forced
# ---------------------------------------------------------------------------
def _port_choices(tc, run):
    """``run()``'s result and, per router call, the port's top-k indices,
    the k-th vs (k+1)-th probability margins and the probabilities' one-ulp
    sensitivity (the normed activations moved by one bf16 ulp)."""
    from repro_torch.models import moe as tmoe
    seen = []
    real = tmoe._router
    k = tc.num_experts_per_tok

    def spy(h, w, k_):
        out = real(h, w, k_)
        probs = torch.softmax(h.float() @ w.float(), -1)
        h2 = (h.float() * (1 + 2.0 ** -8)).to(h.dtype)
        sens = (torch.softmax(h2.float() @ w.float(), -1) - probs
                ).abs().max().item()
        srt = torch.sort(probs, -1, descending=True).values
        seen.append((out[1].numpy(), (srt[..., k - 1] - srt[..., k]).numpy(),
                     sens))
        return out

    tmoe._router = spy
    try:
        result = run()
    finally:
        tmoe._router = real
    return result, seen


def _reference_choices(run):
    """``run()``'s result, run eagerly, and the reference's top-k indices
    per router call."""
    from repro.models import moe as jmoe
    seen = []
    real = jmoe._router

    def spy(h, w, k):
        out = real(h, w, k)
        seen.append(np.asarray(out[1]))
        return out

    jmoe._router = spy
    try:
        with jax.disable_jit():
            result = run()
    finally:
        jmoe._router = real
    return result, seen


def _agreeing_rows(tseen, jseen):
    """(B,) mask of the batch rows whose every routed choice agreed in every
    layer; asserts each disagreement sits at an undecided margin."""
    ok = None
    for (ti, margin, sens), ji in zip(tseen, jseen):
        same = np.all(np.sort(ti, -1) == np.sort(ji, -1), -1)   # (B, S)
        assert np.all(same | (margin <= 2 * sens)), (margin[~same], sens)
        row = same.reshape(same.shape[0], -1).all(-1)
        ok = row if ok is None else ok & row
    return ok


@pytest.mark.parametrize("arch,over", GEN_CASES, ids=GEN_IDS)
def test_prefill_and_decode_steps_match_reference(arch, over):
    jc, tc, jp, tp = _models(arch, over, seed=1)
    rng = np.random.default_rng(2)
    B, S, steps = 3, 12, 8
    capacity = S + steps
    prompt = rng.integers(1, jc.vocab_size, size=(B, S)).astype(np.int32)
    forced = rng.integers(1, jc.vocab_size, size=(B, steps)).astype(np.int32)
    moe = bool(jc.num_experts)

    def jrun():
        logs = []
        lg, caches = jdecode.prefill(jp, jc, CTX, jnp.asarray(prompt),
                                     capacity)
        logs.append(np.asarray(lg, np.float32))
        for i in range(steps):
            lg, caches = jdecode.decode_step(
                jp, jc, CTX, jnp.asarray(forced[:, i:i + 1]),
                jnp.asarray(S + i), caches)
            logs.append(np.asarray(lg, np.float32))
        return logs, caches

    def trun():
        logs = []
        lg, caches = tdecode.prefill(tp, tc, TCTX, torch.tensor(prompt),
                                     capacity)
        logs.append(lg.float().numpy())
        for i in range(steps):
            lg, caches = tdecode.decode_step(
                tp, tc, TCTX, torch.tensor(forced[:, i:i + 1]), S + i, caches)
            logs.append(lg.float().numpy())
        return logs, caches

    if moe:
        (jlogs, jcaches), jseen = _reference_choices(jrun)
        (tlogs, tcaches), tseen = _port_choices(tc, trun)
        # layer calls: prefill, then each step, R layers each
        R = jc.pattern_repeats
        rows = np.ones(B, bool)
        for c in range(1 + steps):
            rows &= _agreeing_rows(tseen[c * R:(c + 1) * R],
                                   jseen[c * R:(c + 1) * R])
            _assert_bf16_close(tlogs[c][rows], jlogs[c][rows],
                               f"logits of call {c}")
        assert rows.sum() >= 2, rows
    else:
        jlogs, jcaches = jrun()
        tlogs, tcaches = trun()
        for c, (tl_, jl_) in enumerate(zip(tlogs, jlogs)):
            _assert_bf16_close(tl_, jl_, f"logits of call {c}")
        for j, (jcache, tcache) in enumerate(zip(jcaches, tcaches)):
            assert int(tcache.length[0]) == int(jcache.length[0]) == S + steps
            for name in ("k", "v"):
                _assert_bf16_close(getattr(tcache, name).float().numpy(),
                                   np.asarray(getattr(jcache, name),
                                              np.float32),
                                   f"entry {j} cache {name}")


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,over", GEN_CASES, ids=GEN_IDS)
def test_generate_greedy_matches_reference(arch, over):
    jc, tc, jp, tp = _models(arch, over, seed=4)
    rng = np.random.default_rng(5)
    B, S, new = 3, 12, 12
    prompt = rng.integers(1, jc.vocab_size, size=(B, S)).astype(np.int32)
    before = paged_attn.launches
    got = tdecode.generate(tp, tc, TCTX, prompt, new)
    assert paged_attn.launches == before
    assert got.shape == (B, new) and got.dtype == torch.int64
    got = got.numpy()
    ref = np.asarray(jdecode.generate(jp, jc, CTX, jnp.asarray(prompt), new))
    compared = 0
    for b in range(B):
        seq = np.concatenate([prompt[b], ref[b, :-1]])[None]
        jlog = np.asarray(jt.forward(jp, jc, CTX, tokens=jnp.asarray(seq))[0],
                          np.float32)[0, S - 1:]
        tlog = tt.forward(tp, tc, tokens=torch.tensor(seq))[0] \
            .float().numpy()[0, S - 1:]
        delta = np.abs(tlog - jlog).max()
        top2 = np.sort(jlog, axis=-1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        tol = max(2 * delta, _ulp(jlog))
        for i in range(new):
            if got[b, i] != ref[b, i]:
                assert margins[i] <= tol, (b, i, got[b].tolist(),
                                           ref[b].tolist())
                break
            compared += 1
    assert compared >= 0.75 * B * new, (compared, got.tolist(), ref.tolist())


def test_generate_samples_from_the_callers_generator():
    _, tc, _, tp = _models("llama3-8b", {}, seed=6)
    prompt = np.random.default_rng(7).integers(1, tc.vocab_size, (2, 8))
    draws = [tdecode.generate(tp, tc, TCTX, prompt, 6, temperature=0.9,
                              generator=torch.Generator().manual_seed(s))
             for s in (11, 11, 12)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < tc.vocab_size
    assert torch.equal(
        tdecode.generate(tp, tc, TCTX, prompt, 6, temperature=0.9),
        tdecode.generate(tp, tc, TCTX, prompt, 6, temperature=0.9))


def test_ring_decode_writes_slot_length_mod_capacity():
    """After prefill of 5 tokens into a ring of 4, the next decode token
    lands in slot 5 % 4 = 1 and the rest of the ring is untouched."""
    _, tc, _, tp = _models("gemma2-2b", {"sliding_window": 4}, seed=8)
    prompt = torch.tensor(np.random.default_rng(9).integers(
        1, tc.vocab_size, (2, 5)))
    _, caches = tdecode.prefill(tp, tc, TCTX, prompt, capacity=16)
    local = caches[0]                       # gemma2's (local, global) unit
    assert local.k.shape[2] == 4 and caches[1].k.shape[2] == 16
    before = local.k.clone()
    _, caches = tdecode.decode_step(tp, tc, TCTX, prompt[:, -1:], 5, caches)
    after = caches[0].k
    assert int(caches[0].length[0]) == 6
    changed = (after != before).flatten(3).any(-1)            # (R, B, C)
    assert changed[..., 1].all() and not changed[..., [0, 2, 3]].any()


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_fields_equal_the_reference(arch):
    """The full config and its smoke variant, field for field."""
    assert arch in ARCHS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke_variant(get_config(arch))) == \
        dataclasses.asdict(jsmoke(jget_config(arch)))
