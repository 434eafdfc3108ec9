"""The port's serving path against the JAX package, on the CPU.

- one paged decode step (``transformer.forward`` over paged caches): logits
  and the updated page pools, for both of the port's attention impls
  against both of the reference's;
- the ``Server`` end to end against the JAX ``Server`` on the same params
  (greedy; continuous through preemption churn, static, a windowed
  softcapped arch, and the MoE archs on both decode routes): the logits of the served sequences, and the tokens,
  which may part only at a step where the reference's top-2 logit margin
  is within twice the logit difference between the packages;
- ``compile_serve``/``ServeSpec`` validation, the page allocator and the
  pool budget.

Activations are bf16 in both packages and round at different places, so
logits are held to 4 bf16 ulps at their largest magnitude (mean half an
ulp), and so are the k/v rows a decode step writes; every other pool entry
must be untouched, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ServeSpec as JaxServeSpec  # noqa: E402
from repro.api import compile_serve as jax_compile_serve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.sharding import ShardingCtx  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.api import ServeSpec, compile_serve  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve.kvcache import PagedKVCache, paged_cache_bytes  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
CTX = ShardingCtx()
MAX_ULPS, MEAN_ULPS = 4, 0.5
IMPLS = [("gather", "gather"), ("pallas", "kernel")]   # reference, port


def _ulp(want):
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _assert_bf16_close(got, want, what):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    d = d / _ulp(np.asarray(want, np.float32))
    assert d.max() <= MAX_ULPS and d.mean() <= MEAN_ULPS, \
        (what, d.max(), d.mean())


def _port(jc):
    return ModelConfig(**dataclasses.asdict(jc))


def _numpy_params(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------------------
# one paged decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,over", [
    ("llama3-8b", {}),
    ("gemma2-2b", {"sliding_window": 8}),    # local layers mask by window
])
@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_paged_decode_step_logits_and_pools(arch, over, jimpl, timpl):
    jc = jax_smoke(jax_get_config(arch)).replace(**over)
    tc = _port(jc)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    tp = _numpy_params(jp)
    rng = np.random.default_rng(1)
    R, B, n, ps = jc.pattern_repeats, 3, 6, 4
    P = 1 + B * n
    shp = (R, P, ps, jc.num_kv_heads, jc.head_dim)
    pools = [(rng.standard_normal(shp), rng.standard_normal(shp))
             for _ in jc.block_pattern]
    pools = [tuple(np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in kv) for kv in pools]
    pt = (rng.permutation(P - 1)[:B * n].reshape(B, n) + 1).astype(np.int32)
    pt[0] = 0                                   # slot 0 idle: null page
    lengths = np.array([0, 5, 23], np.int32)
    toks = rng.integers(1, jc.vocab_size, size=(B, 1)).astype(np.int32)

    jcaches = tuple(jl.PagedKVState(
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        jnp.broadcast_to(jnp.asarray(pt)[None], (R, B, n)),
        jnp.broadcast_to(jnp.asarray(lengths)[None], (R, B)), jimpl)
        for k, v in pools)
    tcaches = tuple(tl.PagedKVState(
        torch.tensor(k).bfloat16(), torch.tensor(v).bfloat16(),
        torch.tensor(pt)[None].expand(R, B, n),
        torch.tensor(lengths)[None].expand(R, B), timpl) for k, v in pools)
    jlog, _, jnew = jt.forward(jp, jc, CTX, tokens=jnp.asarray(toks),
                               positions=jnp.asarray(lengths)[:, None],
                               caches=jcaches)
    tlog, _, tnew = tt.forward(tp, tc, tokens=torch.tensor(toks),
                               positions=torch.tensor(lengths)[:, None],
                               caches=tcaches)
    _assert_bf16_close(tlog.float().numpy(), jlog, "logits")

    # the rows this step wrote: (physical page, offset) of position lengths[b]
    written = np.zeros((P, ps), bool)
    written[pt[np.arange(B), lengths // ps], lengths % ps] = True
    written[0] = False                          # null page: never compared
    for j, (jn, tn) in enumerate(zip(jnew, tnew)):
        np.testing.assert_array_equal(tn.lengths.numpy(),
                                      np.asarray(jn.lengths))
        for name in ("pages_k", "pages_v"):
            want = np.asarray(getattr(jn, name), np.float32)
            got = getattr(tn, name).float().numpy()
            np.testing.assert_array_equal(got[:, 1:][:, ~written[1:]],
                                          want[:, 1:][:, ~written[1:]])
            _assert_bf16_close(got[:, written], want[:, written],
                               f"entry {j} {name}")
            assert not np.array_equal(got[:, written],
                                      pools[j][name == "pages_v"][:, written])


# ---------------------------------------------------------------------------
# Server end to end vs the JAX Server
# ---------------------------------------------------------------------------
def _serve_both(kw, n_req, max_new, seed=7):
    js = jax_compile_serve(JaxServeSpec(**kw, attn_impl="pallas"))
    arch = kw["arch"] if isinstance(kw["arch"], str) else _port(kw["arch"])
    ts = compile_serve(ServeSpec(**dict(kw, arch=arch), attn_impl="kernel"),
                       params=_numpy_params(js.params), device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, js.cfg.vocab_size, size=int(L)).astype(np.int32)
               for L in rng.integers(2, kw["max_prompt"] + 1, size=n_req)]
    for p in prompts:
        js.submit(p, max_new)
        ts.submit(p, max_new)
    jdone = {r.rid: r.output for r in js.drain()}
    tdone = {r.rid: r.output for r in ts.drain()}
    assert sorted(jdone) == sorted(tdone) == list(range(n_req))
    for k in ("steps", "decode_tokens", "prefill_tokens", "preemptions",
              "completed"):
        assert ts.stats[k] == js.stats[k], k
    assert ts.alloc.n_free == kw["num_pages"] - 1     # all pages returned

    compared = total = 0
    for rid, prompt in enumerate(prompts):
        ref, got = jdone[rid], tdone[rid]
        assert len(got) == len(ref) == max_new
        # logits of the served sequence, teacher-forced through both
        seq = np.concatenate([prompt, ref[:-1]])[None]
        jlog = np.asarray(jt.forward(js.params, js.cfg, CTX,
                                     tokens=jnp.asarray(seq))[0], np.float32)
        tlog = tt.forward(ts.params, ts.cfg,
                          tokens=torch.tensor(seq))[0].float().numpy()
        _assert_bf16_close(tlog, jlog, f"request {rid} logits")
        # with |logit difference| <= delta, a top-2 margin above 2 delta fixes
        # the argmax: the first token where the packages differ must be a
        # step where the reference's margin is smaller; past it the
        # continuations (both right) are no longer comparable
        delta = np.abs(tlog - jlog).max()
        steps = jlog[0, len(prompt) - 1:]
        top2 = np.sort(steps, axis=-1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        tol = max(2 * delta, _ulp(jlog))
        for i in range(max_new):
            if got[i] != ref[i]:
                assert margins[i] <= tol, (rid, i, got.tolist(), ref.tolist())
                break
            compared += 1
        total += max_new
    assert compared >= 0.75 * total, (compared, total)
    return ts


def test_server_continuous_with_preemption_matches_reference():
    # 5 usable pages, up to 5 pages/request, 3 slots: forces preemptions
    ts = _serve_both(dict(arch="llama3-8b", smoke=True, max_batch=3,
                          page_size=4, num_pages=6, max_prompt=10,
                          max_new_tokens=8), n_req=5, max_new=5)
    assert ts.stats["preemptions"] > 0 and ts.stats["completed"] == 5


def test_server_static_policy_matches_reference():
    ts = _serve_both(dict(arch="llama3-8b", smoke=True, max_batch=2,
                          page_size=4, num_pages=32, max_prompt=10,
                          max_new_tokens=8, scheduler="static"),
                     n_req=4, max_new=4)
    assert ts.stats["preemptions"] == 0


def test_server_windowed_softcapped_arch_matches_reference():
    # a window of 16 < prompt + decode: prefill rolls the local ring and
    # decode masks by window
    gemma = jax_get_config("gemma2-2b").replace(sliding_window=16)
    _serve_both(dict(arch=gemma, smoke=True, max_batch=3, page_size=4,
                     num_pages=40, max_prompt=40, max_new_tokens=8),
                n_req=4, max_new=8)


# (arch, max_batch): smoke E 4, k 2, so one slot decodes through the sparse
# route (B k < E) and two or three through the all-experts route
MOE_SERVE = [("qwen2-moe-a2.7b", 1), ("qwen2-moe-a2.7b", 3),
             ("mixtral-8x22b", 1), ("mixtral-8x22b", 2)]


@pytest.mark.parametrize("arch,max_batch", MOE_SERVE)
def test_moe_server_matches_reference(arch, max_batch):
    """The MoE archs served end to end (idle slots routed too): the same
    greedy tokens as the reference's Server, to its first near-tie."""
    mixtral = jax_get_config(arch).replace(sliding_window=16)
    ts = _serve_both(dict(arch=mixtral if arch == "mixtral-8x22b" else arch,
                          smoke=True, max_batch=max_batch, page_size=4,
                          num_pages=32, max_prompt=12, max_new_tokens=8),
                     n_req=3, max_new=8)
    assert ts.cfg.num_experts and ts.stats["completed"] == 3
    assert "moe" in ts.params["blocks"][0]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x22b",
                                  "gemma-2b", "h2o-danube-3-4b",
                                  "llama-100m"])
def test_compile_serve_accepts_the_slices_archs(arch):
    srv = compile_serve(ServeSpec(arch=arch, smoke=True, max_batch=2,
                                  page_size=4, num_pages=16, max_prompt=8,
                                  max_new_tokens=4), device="cpu")
    srv.submit(np.arange(1, 6), 4)
    done = srv.drain()
    assert len(done) == 1 and len(done[0].tokens) == 4
    assert all(0 <= t < srv.cfg.vocab_size for t in done[0].tokens)


# ---------------------------------------------------------------------------
# compile_serve / ServeSpec validation, allocator, budget
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,why", [
    ("xlstm-125m", "attention blocks only"),    # slstm/mlstm pattern
    ("zamba2-2.7b", "attention blocks only"),   # mamba hybrid
    ("musicgen-medium", "codebook"),            # codebook heads
    ("qwen2-vl-2b", "M-RoPE"),                  # vision frontend + mrope
    ("vgg-a", "ModelConfig"),                   # CNN family
])
def test_compile_serve_rejects_unservable_archs(arch, why):
    jc = jax_get_config(arch)
    cfg = _port(jc) if dataclasses.is_dataclass(jc) and hasattr(
        jc, "block_pattern") else jc
    with pytest.raises(ValueError, match=why):
        compile_serve(ServeSpec(arch=cfg, smoke=True), device="cpu")


def test_compile_serve_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_serve(ServeSpec(arch="llama3-8b", smoke=True))
    srv = compile_serve(ServeSpec(arch="llama3-8b", smoke=True), device="cpu")
    assert srv.device.type == "cpu"
    assert srv.params["embed"].device.type == "cpu"
    # CNN and DNN configs are known (the training slices) but not servable,
    # as in the reference
    with pytest.raises(ValueError, match="token LM ModelConfig"):
        compile_serve(ServeSpec(arch="cd-dnn", smoke=True), device="cpu")
    with pytest.raises(ValueError, match="token LM ModelConfig"):
        compile_serve(ServeSpec(arch="vgg-a", smoke=True), device="cpu")


def test_servespec_validates():
    with pytest.raises(ValueError, match="scheduler"):
        ServeSpec(arch="llama3-8b", scheduler="fifo")
    with pytest.raises(ValueError, match="attn_impl"):
        ServeSpec(arch="llama3-8b", attn_impl="pallas")
    with pytest.raises(ValueError, match="num_pages"):
        ServeSpec(arch="llama3-8b", num_pages=4, max_prompt=64,
                  max_new_tokens=64, page_size=16)
    spec = ServeSpec(arch="llama3-8b", max_prompt=60, max_new_tokens=5,
                     page_size=16)
    assert spec.max_context == 65 and spec.pages_per_request == 5
    assert spec.attn_impl == "kernel"


def test_server_admission_control():
    srv = compile_serve(ServeSpec(arch="llama3-8b", smoke=True, max_queue=2,
                                  max_prompt=8, max_new_tokens=4),
                        device="cpu")
    with pytest.raises(ValueError, match="prompt length"):
        srv.submit(np.ones(9, np.int32))
    with pytest.raises(ValueError, match="vocab_size"):
        srv.submit(np.full(4, srv.cfg.vocab_size, np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.submit(np.ones(4, np.int32), 5)
    srv.submit(np.ones(4, np.int32))
    srv.submit(np.ones(4, np.int32))
    with pytest.raises(RuntimeError, match="max_queue"):
        srv.submit(np.ones(4, np.int32))


def test_decode_logits_impls_agree_and_do_not_advance():
    srv = compile_serve(ServeSpec(arch="llama3-8b", smoke=True,
                                  max_prompt=12, max_new_tokens=4),
                        device="cpu")
    for L in (3, 12):
        srv.submit(np.arange(1, L + 1))
    srv.step()
    lengths = srv._lengths.copy()
    a = srv.decode_logits("gather")
    b = srv.decode_logits("kernel")
    assert torch.equal(a, b)           # on the CPU both are the plain version
    np.testing.assert_array_equal(srv._lengths, lengths)


@pytest.mark.parametrize("num_pages,page_size", [(8, 4), (32, 16)])
def test_paged_cache_bytes_matches_init_paged_caches(num_pages, page_size):
    cfg = smoke_variant(get_config("gemma2-2b"))
    caches = tt.init_paged_caches(cfg, 2, num_pages, page_size,
                                  pages_per_req=4, device="cpu")
    floats = sum(t.numel() * t.element_size() for c in caches
                 for t in (c.pages_k, c.pages_v))
    assert paged_cache_bytes(cfg, num_pages, page_size) == floats


def test_allocator():
    a = PagedKVCache(num_pages=8, page_size=4)
    assert a.n_free == 7                       # page 0 never handed out
    got = a.alloc(rid=1, n=3)
    assert 0 not in got
    assert a.alloc(2, 5) is None and a.n_owned(2) == 0   # all or nothing
    assert a.ensure(1, 3) and a.n_owned(1) == 3          # no-op
    assert a.ensure(1, 5) and a.n_owned(1) == 5
    assert a.page_row(1, 7).tolist() == a._owned[1] + [0, 0]
    assert a.free(1) == 5 and a.n_free == 7
    assert a.pages_for(4) == 1 and a.pages_for(5) == 2
