"""The port's state-space and recurrent blocks (``repro_torch.models.ssm``)
against the JAX package's (``repro.models.ssm``), on the CPU.

Inputs come from numpy seeds and go through both packages; block params are
the reference's (``jax.random`` init) carried over as numpy.

- ``ssd_chunked`` (Mamba2's chunked scan) at chunks 4, 8 and 16 of a
  32-step sequence, from a zero and from a given initial state;
  ``_mlstm_chunk_scan`` at chunks 4 and 16, with and without a carried
  state; the sLSTM scan (``slstm_scan`` against the reference's
  ``lax.scan`` of ``_slstm_step``); each output and final state in f32 to
  rtol 1e-5 (atol 1e-5 of the largest magnitude: the same f32 terms summed
  in other orders and groupings), and the scans' gradients to 1e-4
  relative L2 (measured at most 4.3e-7).
- ``mamba_block``, ``mlstm_block`` and ``slstm_block`` on f32 activations:
  outputs to 1e-5 of their largest magnitude, every gradient leaf to 1e-4
  relative L2 (measured at most 4.6e-6); the blocks with bf16
  activations, as the models run them: outputs within 4 bf16 ulps at
  their largest magnitude with a mean under 0.75 of one (the tolerance of
  ``tests/test_torch_decode.py``; both frameworks round the bf16 products
  and casts at other places; measured at most 1 ulp, mean 0.11), every
  gradient leaf to 5e-2 relative L2 (``tests/test_torch_lm_train.py``'s;
  measured at most 1.3e-2, mLSTM's).
- decode: a prefill of 12 tokens filling the cache, then 4 one-token
  steps, teacher-forced, in both packages: the same output tolerances
  (measured at most 2 ulps, mean 0.20),
  and the carried states in f32 to 1e-2 of their largest magnitude (they
  are sums over bf16-rounded inputs).  The port's own prefill + steps
  against its full-sequence forward at the reference's
  ``test_arch_decode_consistency`` tolerance (rtol = atol = 0.05).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core.params import init_tree as jinit_tree  # noqa: E402
from repro.core.sharding import ShardingCtx  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.core.sharding import ShardingCtx as TShardingCtx  # noqa: E402,E501
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as ts  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
jax.config.update("jax_default_matmul_precision", "highest")
CTX = ShardingCtx()
TCTX = TShardingCtx()
F32_TOL = 1e-5
F32_GRAD_REL_L2 = 1e-4
MAX_ULPS, MEAN_ULPS = 4, 0.75
GRAD_REL_L2 = 5e-2
STATE_TOL = 1e-2
DECODE_RTOL = DECODE_ATOL = 0.05

# block kind -> (smoke config, reference block, port block, specs, cache)
BLOCKS = {
    "mamba": ("zamba2-2.7b", js.mamba_block, ts.mamba_block, js.mamba_specs,
              js.init_mamba_cache, ts.init_mamba_cache),
    "mlstm": ("xlstm-125m", js.mlstm_block, ts.mlstm_block, js.mlstm_specs,
              js.init_mlstm_cache, ts.init_mlstm_cache),
    "slstm": ("xlstm-125m", js.slstm_block, ts.slstm_block, js.slstm_specs,
              js.init_slstm_cache, ts.init_slstm_cache),
}


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol=F32_TOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    d = np.abs(got - want) / ulp
    return d.max(), d.mean()


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# the scans in f32
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, B=2, S=32, H=3, P=4, N=5):
    r = _rng(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(r.standard_normal(H) * 0.5).astype(np.float32)
    Bm = r.standard_normal((B, S, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, N)).astype(np.float32)
    s0 = r.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(chunk, with_state):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(chunk)
    init = s0 if with_state else None
    wy, wst = js.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                             chunk=chunk, init_state=None if init is None
                             else jnp.asarray(init))
    gy, gst = ts.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk=chunk,
                             init_state=None if init is None else _t(init))
    _close(gy.numpy(), wy)
    _close(gst.numpy(), wst)


def test_ssd_chunked_gradients_match_reference():
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(7)
    w = _rng(8).standard_normal(x.shape).astype(np.float32)

    def jloss(*a):
        y, st = js.ssd_chunked(*a[:5], chunk=8, init_state=a[5])
        return jnp.sum(y * w) + jnp.sum(st)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *map(jnp.asarray, (x, dt, A, Bm, Cm, s0)))
    ins = [_t(a, True) for a in (x, dt, A, Bm, Cm, s0)]
    y, st = ts.ssd_chunked(*ins[:5], chunk=8, init_state=ins[5])
    got = torch.autograd.grad((y * _t(w)).sum() + st.sum(), ins)
    for g, r in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert _rel_l2(g.numpy(), r) <= F32_GRAD_REL_L2


def _mlstm_inputs(seed, B=2, S=32, H=2, P=4):
    r = _rng(seed)
    q, k, v = (r.standard_normal((B, S, H, P)).astype(np.float32)
               for _ in range(3))
    log_f = -np.log1p(np.exp(-r.standard_normal((B, S, H)) - 2)) \
        .astype(np.float32)
    log_i = r.standard_normal((B, S, H)).astype(np.float32)
    cache = (r.standard_normal((B, H, P, P)).astype(np.float32),
             r.standard_normal((B, H, P)).astype(np.float32),
             r.standard_normal((B, H)).astype(np.float32))
    return q, k, v, log_f, log_i, cache


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunk_scan_matches_reference(chunk, with_state):
    q, k, v, log_f, log_i, (C0, n0, m0) = _mlstm_inputs(chunk)
    zero = np.zeros((), np.int32)
    jc = js.MlstmCache(*map(jnp.asarray, (C0, n0, m0, zero))) \
        if with_state else None
    tc = ts.MlstmCache(*map(_t, (C0, n0, m0, zero))) if with_state else None
    wy, wst = js._mlstm_chunk_scan(*map(jnp.asarray, (q, k, v, log_f,
                                                      log_i)), chunk, jc)
    gy, gst = ts._mlstm_chunk_scan(*map(_t, (q, k, v, log_f, log_i)), chunk,
                                   tc)
    _close(gy.numpy(), wy)
    for g, w in zip(gst, wst):
        _close(g.numpy(), w)


def test_mlstm_chunk_scan_gradients_match_reference():
    q, k, v, log_f, log_i, _ = _mlstm_inputs(3)
    w = _rng(4).standard_normal(q.shape).astype(np.float32)

    def jloss(*a):
        y, (C, n, _) = js._mlstm_chunk_scan(*a, 8, None)
        return jnp.sum(y * w) + jnp.sum(C) + jnp.sum(n)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *map(jnp.asarray, (q, k, v, log_f, log_i)))
    ins = [_t(a, True) for a in (q, k, v, log_f, log_i)]
    y, (C, n, _) = ts._mlstm_chunk_scan(*ins, 8, None)
    got = torch.autograd.grad((y * _t(w)).sum() + C.sum() + n.sum(), ins)
    for g, r in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert _rel_l2(g.numpy(), r) <= F32_GRAD_REL_L2


def _slstm_params(jc, seed):
    return jax.tree.map(np.asarray, jinit_tree(js.slstm_specs(jc),
                                               jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_reference(with_state):
    jc = jsmoke(jget_config("xlstm-125m"))
    H, d = jc.num_heads, jc.d_model
    P = d // H
    p = _slstm_params(jc, 0)
    r = _rng(5)
    wx = r.standard_normal((2, 24, 4 * d)).astype(np.float32)
    if with_state:
        carry = tuple(r.standard_normal((2, d)).astype(np.float32)
                      for _ in range(4))
    else:
        z = np.zeros((2, d), np.float32)
        carry = (z, z, z, np.full((2, d), -1e30, np.float32))
    jp = jax.tree.map(jnp.asarray, p)

    def step(c, x):
        new = js._slstm_step(jp, H, P, c, x)
        return new, new[0]

    wcarry, wys = lax.scan(step, tuple(map(jnp.asarray, carry)),
                           jnp.asarray(wx).transpose(1, 0, 2))
    gys, gcarry = ts.slstm_scan(params_from_numpy(p, "cpu"), H, P,
                                tuple(map(_t, carry)), _t(wx))
    _close(gys.numpy(), np.asarray(wys).transpose(1, 0, 2))
    for g, w in zip(gcarry, wcarry):
        _close(g.numpy(), w)


# ---------------------------------------------------------------------------
# the blocks: f32 and bf16 activations, gradients, decode
# ---------------------------------------------------------------------------
def _block_setup(kind, seed=0):
    arch, jblock, tblock, specs, jcache, tcache = BLOCKS[kind]
    jc = jsmoke(jget_config(arch))
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = jinit_tree(specs(jc), jax.random.PRNGKey(seed))
    # the zero-initialised norms and biases get values, so that their
    # gradients and the paths through them are not trivial
    r = _rng(seed + 100)
    jp = {k: (v + 0.1 * r.standard_normal(v.shape).astype(np.float32)
              if k in ("norm", "gate_norm", "out_norm", "conv_b", "dt_bias",
                       "b_if", "b") else v) for k, v in
          jax.tree.map(np.asarray, jp).items()}
    return jc, tc, jp, jblock, tblock, jcache, tcache


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_forward_and_gradients_match_reference(kind, dtype):
    jc, tc, jp, jblock, tblock, _, _ = _block_setup(kind)
    S = 40
    x = _rng(1).standard_normal((2, S, jc.d_model)).astype(np.float32)
    w = _rng(2).standard_normal(x.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16

    def jloss(p, xx):
        y, _ = jblock(p, xx.astype(jdt), jc, CTX)
        return jnp.sum(y.astype(jnp.float32) * w), y

    (_, wy), wg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = params_from_numpy(jp, "cpu")
    tx = _t(x, True)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    y, _ = tblock(tp, tx.to(tdt), tc, TCTX)
    assert y.dtype == tdt and y.shape == x.shape
    grads = torch.autograd.grad((y.float() * _t(w)).sum(), leaves + [tx])
    want_g = jax.tree.leaves(wg[0]) + [wg[1]]
    if dtype == "f32":
        _close(y.detach().numpy(), wy)
        tol = F32_GRAD_REL_L2
    else:
        worst, mean = _ulps(y.detach().float().numpy(), wy)
        assert worst <= MAX_ULPS and mean <= MEAN_ULPS, (worst, mean)
        tol = GRAD_REL_L2
    for g, r in zip(grads, want_g):
        assert np.isfinite(g.numpy()).all()
        assert _rel_l2(g.numpy(), r) <= tol, (_rel_l2(g.numpy(), r), tol)


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_prefill_and_decode_match_reference(kind):
    jc, tc, jp, jblock, tblock, jcache, tcache = _block_setup(kind, 3)
    S0, steps = 12, 4
    x = _rng(4).standard_normal((2, S0 + steps, jc.d_model)) \
        .astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = torch.tensor(x).to(torch.bfloat16)
    jpj = jax.tree.map(jnp.asarray, jp)
    tp = params_from_numpy(jp, "cpu")
    jstep = jax.jit(lambda xx, c: jblock(jpj, xx, jc, CTX, cache=c))
    with torch.no_grad():
        wy, jc_ = jstep(xb[:, :S0], jcache(jc, 2))
        gy, tc_ = tblock(tp, tx[:, :S0], tc, TCTX, cache=tcache(tc, 2))
        outs = [(gy, wy)]
        for t in range(S0, S0 + steps):
            wy, jc_ = jstep(xb[:, t:t + 1], jc_)
            gy, tc_ = tblock(tp, tx[:, t:t + 1], tc, TCTX, cache=tc_)
            outs.append((gy, wy))
        full, _ = tblock(tp, tx, tc, TCTX)
    for g, w in outs:
        worst, mean = _ulps(g.float().numpy(), w)
        assert worst <= MAX_ULPS and mean <= MEAN_ULPS, (worst, mean)
    for f in dataclasses.fields(tc_):
        got, want = getattr(tc_, f.name), getattr(jc_, f.name)
        if f.name == "length":
            assert int(got) == int(want) == S0 + steps
        else:
            _close(got.numpy(), want, STATE_TOL)
    # the port's own prefill + steps against its full forward
    dec = torch.cat([g for g, _ in outs], dim=1).float().numpy()
    np.testing.assert_allclose(dec, full.float().numpy(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)


def test_caches_have_the_reference_fields_and_shapes():
    jc = jsmoke(jget_config("zamba2-2.7b"))
    tc = ModelConfig(**dataclasses.asdict(jc))
    xc = ModelConfig(**dataclasses.asdict(jsmoke(jget_config("xlstm-125m"))))
    jx = jsmoke(jget_config("xlstm-125m"))
    for jinit, tinit, jcfg, tcfg in (
            (js.init_mamba_cache, ts.init_mamba_cache, jc, tc),
            (js.init_mlstm_cache, ts.init_mlstm_cache, jx, xc),
            (js.init_slstm_cache, ts.init_slstm_cache, jx, xc)):
        want, got = jinit(jcfg, 3), tinit(tcfg, 3)
        assert [f.name for f in dataclasses.fields(want)] == \
            [f.name for f in dataclasses.fields(got)]
        for f in dataclasses.fields(want):
            w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name)
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(g.numpy(), w)
    assert ts.mamba_dims(tc) == js.mamba_dims(jc)
    assert ts.mlstm_dims(xc) == js.mlstm_dims(jx)
