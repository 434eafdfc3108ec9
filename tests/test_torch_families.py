"""The SSM, hybrid, vision and audio families of the port against the JAX
package, on the CPU, at their smoke sizes: xlstm-125m (mLSTM and sLSTM
blocks), zamba2-2.7b (Mamba2 blocks and one shared attention+MLP block),
qwen2-vl-2b (vision stub embeddings, M-RoPE) and musicgen-medium (audio
frame embeddings, four codebook heads).

Params are the reference's (``jax.random`` init) carried over as numpy;
batches come bitwise from both packages' seeded streams.

- configs: the four configs and their smoke variants field for field; the
  registries hold the same archs.
- ``lm_loss`` and every gradient leaf, on both attention routes, with bf16
  activations as the models run: the loss to 1e-3 relative and every leaf
  to 5e-2 relative L2 (``tests/test_torch_lm_train.py``'s tolerances).
  Two of the smoke models are more sensitive to where bf16 rounds than
  that bound: the reference's own gradients, computed eagerly
  (``jax.disable_jit``) and jitted, part by 0.266 relative L2 (zamba2,
  every Mamba leaf) and 0.056 (xlstm), against 0.011-0.014 for qwen2-vl
  and musicgen; the port parts from the jitted reference by 0.25 and 0.05.
  So a model's leaves are held to the larger of 5e-2 and twice the
  reference's own spread (``SPREAD``), and the model's wiring is held
  tightly on f32 activations (``transformer.ACTIVATION_DTYPE`` and the
  reference's bf16 cast both set to f32): the loss to 1e-5, every leaf to
  1e-3 relative L2 (measured at most 6.3e-5, zamba2's).
  Zamba2 also runs at two pattern repeats, so that its shared block's
  gradient is the sum over two uses, in both packages.
- decode: prefill + teacher-forced decode steps, the logits to 4 bf16 ulps
  at their largest magnitude with a mean under 0.75 of one
  (``tests/test_torch_decode.py``'s); zamba2's and xlstm's to 8 ulps and a
  mean of 1.5, since the reference's own eager and jitted decode logits
  part by up to 4.7 ulps, mean 1.03 (zamba2) and 7.0, mean 1.06 (xlstm),
  against 1.5, mean 0.31 for qwen2-vl; the port's prefill(S) + decode(1) against its full
  forward at position S within the reference's
  ``test_arch_decode_consistency`` tolerance (rtol = atol = 0.05); greedy
  ``generate`` tokens equal to the reference's up to the first step where
  the reference's top-2 margin is within twice the logits' difference.
- training: a 3-step serial ``compile_run`` fit from the reference's
  initial params, each step's loss to 1e-3 relative.  Zamba2's AdamW
  steps follow gradients that bf16 rounding moves by 25% (its third loss
  parted by 3.5e-3 on bf16 activations), so its fit runs on f32
  activations in both packages (measured 5.6e-5 at the third step: AdamW's
  first steps move a weight by about the learning rate whatever its
  gradient's size, so a near-zero gradient that f32 rounding flips flips
  its step too); musicgen's
  ``embed`` and ``lm_head``, which its loss does not reach, take zero
  gradients and move by AdamW's weight decay alone, as in the reference
  (to 1e-6).
- zamba2 under zero1 at G = 2, on f32 activations: the bucket plan of its
  tree (with the shared subtree and the empty ``{}`` entry) is the
  reference's, slot for slot; the port's 4-step zero1 fit against the
  reference's (one subprocess on 2 forced host devices), each logged loss
  to 1e-3 (measured 1.4e-4 at step 4); checkpoints that resume across the packages (the reference's
  step-2 checkpoint in the port, the port's in the reference) within 5e-3
  of the uninterrupted run's final loss (the tolerance of
  ``tests/test_torch_checkpoint.py``).
- ``compile_serve`` refuses the four archs by id, as the reference does;
  the training CLI runs ``--arch zamba2-2.7b --smoke``.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import ServeSpec as JServeSpec  # noqa: E402
from repro.api import compile_run as jcompile_run  # noqa: E402
from repro.api import compile_serve as jcompile_serve  # noqa: E402
from repro.api.families import adapter_for as jadapter_for  # noqa: E402
from repro.comm.bucketer import plan_buckets as jplan_buckets  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.configs.registry import _MODULES as JMODULES  # noqa: E402
from repro.core.sharding import ShardingCtx  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro_torch.api import MeshSpec, RunSpec, ServeSpec  # noqa: E402
from repro_torch.core.sharding import ShardingCtx as TShardingCtx  # noqa: E402,E501
from repro_torch.api import compile_run, compile_serve  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.comm.bucketer import plan_buckets  # noqa: E402
from repro_torch.configs import ARCHS, ModelConfig, get_config  # noqa: E402
from repro_torch.configs import smoke_variant  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve import decode as tdecode  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))
CTX = ShardingCtx()
TCTX = TShardingCtx()
FAMILY_ARCHS = ["xlstm-125m", "zamba2-2.7b", "qwen2-vl-2b",
                "musicgen-medium"]
LOSS_REL = 1e-3
GRAD_REL_L2 = 5e-2
# the reference's own gradients, eager against jitted (module docstring)
SPREAD = {"zamba2-2.7b": 0.266, "xlstm-125m": 0.056}
F32_LOSS_REL = 1e-5
F32_GRAD_REL_L2 = 1e-3
MAX_ULPS, MEAN_ULPS = 4, 0.75
DECODE_RTOL = DECODE_ATOL = 0.05
RESUME_TOL = 5e-3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REFERENCE_TIMEOUT_S = 300

# (arch, overrides): the four smoke models; zamba2 also at two repeats
CASES = [(a, {}) for a in FAMILY_ARCHS] + [
    ("zamba2-2.7b", {"num_layers": 12, "pattern_repeats": 2})]
CASE_IDS = ["-".join([a] + [f"{k}{v}" for k, v in o.items()])
            for a, o in CASES]
_REFERENCE = {}


def _cfgs(arch, **over):
    jc = jsmoke(jget_config(arch)).replace(**over)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _seq(jc, text=32):
    return text + (jc.vision_tokens if jc.frontend == "vision" else 0)


def _rel_l2(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(np.asarray(got, np.float32) - want)
                 / np.linalg.norm(want))


def _ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    d = np.abs(got - want) / ulp
    return d.max(), d.mean()


class _F32:
    """``jnp`` with ``bfloat16`` meaning f32: the reference's forward casts
    its embeddings to ``jnp.bfloat16``, and every layer then follows the
    residual stream's type."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _activations(f32: bool):
    """Both packages' residual stream in f32 (``f32``) or as they run."""
    real_j, real_t = jt.jnp, tt.ACTIVATION_DTYPE
    if f32:
        jt.jnp, tt.ACTIVATION_DTYPE = _F32(), torch.float32
    try:
        yield
    finally:
        jt.jnp, tt.ACTIVATION_DTYPE = real_j, real_t


def _reference(case, f32=False):
    """The reference's params (as numpy), batch, loss and gradient leaves
    for one of ``CASES``, computed once per module."""
    key = (case, f32)
    if key not in _REFERENCE:
        arch, over = CASES[case]
        jc, _ = _cfgs(arch, **over)
        jp = jt.init_params(jc, jax.random.PRNGKey(case))
        b = next(jadapter_for(jc).stream(jc, 2, _seq(jc), case))
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        with _activations(f32):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jt.lm_loss(p, jc, CTX, jb)))(jp)
        _REFERENCE[key] = (jax.tree.map(np.asarray, jp), b, float(loss),
                           [np.asarray(g) for g in jax.tree.leaves(grads)])
    return _REFERENCE[key]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_config_fields_equal_the_reference(arch):
    assert arch in ARCHS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke_variant(get_config(arch))) == \
        dataclasses.asdict(jsmoke(jget_config(arch)))


def test_registry_holds_every_reference_arch():
    assert sorted(ARCHS) == sorted(JMODULES)


def _paths(tree, prefix=""):
    """``jax.tree_util.keystr`` of every leaf, in the leaves' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}[{i}]")
    else:
        yield prefix


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_param_tree_is_the_reference(arch):
    jc, tc = _cfgs(arch)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = tt.init_params(tc, 0, "cpu")
    assert list(zip(_paths(got), [tuple(t.shape) for t in
                                  tree_leaves(got)])) == want
    if arch == "zamba2-2.7b":
        assert got["blocks"][-1] == {} and set(got["shared"]) == {"attn",
                                                                  "mlp"}


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def _port_loss_and_grads(case, nparams, b, route, f32=False):
    arch, over = CASES[case]
    _, tc = _cfgs(arch, **over)
    params = params_from_numpy(nparams, "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    batch = {k: torch.tensor(np.asarray(v)) for k, v in b.items()}
    with _activations(f32):
        before = fa.launches
        loss = tt.lm_loss(params, tc, TCTX, batch,
                          use_kernel=route == "kernel")
        assert fa.launches == before       # CPU tensors: the plain version
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss, grads


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_lm_loss_and_grads_match_reference(case, route):
    nparams, b, jloss, jgrads = _reference(case)
    loss, grads = _port_loss_and_grads(case, nparams, b, route)
    assert abs(loss.item() - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)
    tol = max(GRAD_REL_L2, 2 * SPREAD.get(CASES[case][0], 0.0))
    assert len(grads) == len(jgrads)
    for g, r in zip(grads, jgrads):
        assert g.shape == r.shape and np.isfinite(g.numpy()).all()
        if np.any(r):
            assert _rel_l2(g.numpy(), r) <= tol, (_rel_l2(g.numpy(), r), tol)
        else:
            assert not g.any()


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_f32_wiring_matches_reference(case):
    nparams, b, jloss, jgrads = _reference(case, f32=True)
    loss, grads = _port_loss_and_grads(case, nparams, b, "plain", f32=True)
    assert abs(loss.item() - jloss) <= F32_LOSS_REL * abs(jloss)
    for g, r in zip(grads, jgrads):
        if np.any(r):
            assert _rel_l2(g.numpy(), r) <= F32_GRAD_REL_L2
        else:
            assert not g.any()


def test_audio_loss_leaves_embed_and_lm_head_unreached():
    case = FAMILY_ARCHS.index("musicgen-medium")
    nparams, b, _, jgrads = _reference(case)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(nparams)[0]]
    _, grads = _port_loss_and_grads(case, nparams, b, "plain")
    for n, g, r in zip(names, grads, jgrads):
        unreached = n in ("['embed']", "['lm_head']")
        assert (not np.any(r)) == unreached, n
        assert (not g.any()) == unreached, n


# ---------------------------------------------------------------------------
# decode and generate
# ---------------------------------------------------------------------------
DECODE_ARCHS = ["xlstm-125m", "zamba2-2.7b", "qwen2-vl-2b"]


def _models(arch, seed):
    jc, tc = _cfgs(arch)
    jp = jt.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    jc, tc, jp, tp = _models(arch, 1)
    rng = np.random.default_rng(2)
    B, S, steps = 2, 12, 6
    prompt = rng.integers(1, jc.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(1, jc.vocab_size, (B, steps)).astype(np.int32)
    jpre = jax.jit(lambda p, t: jdecode.prefill(p, jc, CTX, t, S + steps))
    jstep = jax.jit(lambda p, t, i, c: jdecode.decode_step(p, jc, CTX, t,
                                                           i, c))
    lg, jc_ = jpre(jp, jnp.asarray(prompt))
    jlogs = [np.asarray(lg, np.float32)]
    tl, tc_ = tdecode.prefill(tp, tc, TCTX, torch.tensor(prompt),
                                  S + steps)
    tlogs = [tl.float().numpy()]
    for i in range(steps):
        lg, jc_ = jstep(jp, jnp.asarray(forced[:, i:i + 1]), jnp.asarray(S + i),
                        jc_)
        jlogs.append(np.asarray(lg, np.float32))
        tl, tc_ = tdecode.decode_step(tp, tc, TCTX,
                                        torch.tensor(forced[:, i:i + 1]),
                                      S + i, tc_)
        tlogs.append(tl.float().numpy())
    scale = 2 if arch in SPREAD else 1
    for c, (a, w) in enumerate(zip(tlogs, jlogs)):
        worst, mean = _ulps(a, w)
        assert worst <= scale * MAX_ULPS and mean <= scale * MEAN_ULPS, \
            (c, worst, mean)
    for jcache, tcache in zip(jc_, tc_):
        assert [f.name for f in dataclasses.fields(jcache)] == \
            [f.name for f in dataclasses.fields(tcache)]
        np.testing.assert_array_equal(tcache.length.numpy(),
                                      np.asarray(jcache.length))
        assert int(tcache.length[0]) == S + steps
        for f in dataclasses.fields(tcache):
            assert tuple(getattr(tcache, f.name).shape) == \
                np.asarray(getattr(jcache, f.name)).shape, f.name


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_plus_decode_is_the_full_forward(arch):
    """prefill(S) + decode(1) logits == the full forward's at position S
    (the reference's ``test_arch_decode_consistency``), with M-RoPE
    positions for qwen2-vl."""
    _, tc, _, tp = _models(arch, 2)
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, tc.vocab_size, (2, 17)))
    with torch.no_grad():
        full = tt.forward(tp, tc, tokens=tokens)[0]
        _, caches = tdecode.prefill(tp, tc, TCTX, tokens[:, :16], 24)
        dec, _ = tdecode.decode_step(tp, tc, TCTX, tokens[:, 16:17], 16,
                                     caches)
    np.testing.assert_allclose(dec.float().numpy(),
                               full[:, 16].float().numpy(),
                               rtol=DECODE_RTOL, atol=DECODE_ATOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_generate_greedy_matches_reference(arch):
    jc, tc, jp, tp = _models(arch, 4)
    B, S, new = 2, 12, 10
    prompt = np.random.default_rng(5).integers(1, jc.vocab_size, (B, S)) \
        .astype(np.int32)
    got = tdecode.generate(tp, tc, TCTX, prompt, new)
    assert got.shape == (B, new) and got.dtype == torch.int64
    got = got.numpy()
    ref = np.asarray(jdecode.generate(jp, jc, CTX, jnp.asarray(prompt), new))
    fwd = jax.jit(lambda p, t: jt.forward(p, jc, CTX, tokens=t)[0])
    compared = 0
    for b in range(B):
        seq = np.concatenate([prompt[b], ref[b, :-1]])[None]
        jlog = np.asarray(fwd(jp, jnp.asarray(seq)), np.float32)[0, S - 1:]
        with torch.no_grad():
            tlog = tt.forward(tp, tc, tokens=torch.tensor(seq))[0] \
                .float().numpy()[0, S - 1:]
        delta = np.abs(tlog - jlog).max()
        top2 = np.sort(jlog, axis=-1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        for i in range(new):
            if got[b, i] != ref[b, i]:
                assert margins[i] <= 2 * delta, (b, i, got[b], ref[b])
                break
            compared += 1
    assert compared >= 0.5 * B * new, (compared, got, ref)


def test_vision_prefill_takes_embeds():
    """``prefill(embeds=)`` for qwen2-vl: the image's embeddings, then the
    text, in one sequence; the last logits equal the forward's."""
    _, tc, _, tp = _models("qwen2-vl-2b", 6)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.frontends import vision_stub_embeds
    emb = vision_stub_embeds(gen, 2, tc.vision_tokens, tc.d_model)
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, tc.vocab_size, (2, 8)))
    with torch.no_grad():
        full = tt.forward(tp, tc, tokens=toks, embeds=emb)[0]
        last, caches = tdecode.prefill(tp, tc, TCTX, toks, 40, embeds=emb)
    assert torch.equal(last, full[:, -1])
    assert int(caches[0].length[0]) == tc.vision_tokens + 8


# ---------------------------------------------------------------------------
# training: compile_run, the zero1 plan, checkpoints across packages
# ---------------------------------------------------------------------------
FIT = dict(smoke=True, batch=2, steps=3, lr=5e-3, schedule="constant",
           log_every=1)


def _reference_fit(arch):
    spec = JRunSpec(arch=arch, seq=_seq(jsmoke(jget_config(arch))), **FIT)
    run = jcompile_run(spec)
    init = jax.tree.map(np.asarray, run.params)
    hist = run.fit(log_fn=lambda *_: None)
    run.close()
    return init, [h["loss"] for h in hist], jax.tree.map(np.asarray,
                                                          run.params)


# (arch, f32 activations): zamba2's AdamW steps follow its gradients, which
# bf16 rounding moves by 25% (module docstring), so its fit is held on f32
# activations; musicgen's as it runs
FITS = [("zamba2-2.7b", True), ("musicgen-medium", False)]


@pytest.mark.parametrize("arch,f32", FITS)
def test_compile_run_fit_matches_reference(arch, f32):
    spec = RunSpec(arch=arch, seq=_seq(jsmoke(jget_config(arch))), **FIT)
    with _activations(f32):
        init, jhist, jfinal = _reference_fit(arch)
        with compile_run(spec, device="cpu") as run:
            run.params = params_from_numpy(init, "cpu")
            run.opt_state = run.optimizer.init(run.params)
            hist = run.fit(start_step=0, log_fn=lambda *_: None)
    losses = [h["loss"] for h in hist]
    assert len(losses) == len(jhist) == 3
    for a, w in zip(losses, jhist):
        assert abs(a - w) <= LOSS_REL * abs(w), (losses, jhist)
    if arch == "musicgen-medium":
        # zero gradients: AdamW moves these leaves by weight decay alone
        for k in ("embed", "lm_head"):
            got = run.params[k].detach().numpy()
            assert not np.array_equal(got, init[k])
            np.testing.assert_allclose(got, jfinal[k], rtol=1e-6, atol=0)


BB = 2 ** 18
Z_SPEC = dict(arch="zamba2-2.7b", smoke=True, batch=2, seq=32, lr=5e-3,
              schedule="constant", log_every=100)
Z_STEPS, Z_SAVE = 4, 2

_ZERO1_REFERENCE = """
import repro.jaxcompat
import json
import jax
import jax.numpy as jnp
from repro.api import MeshSpec, RunSpec, compile_run
from repro.comm import CommConfig
from repro.models import transformer


class F32:
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


transformer.jnp = F32()     # the residual stream in f32 (module docstring)


def fit(**kw):
    run = compile_run(RunSpec(parallel="zero1", mesh=MeshSpec(),
                              comm=CommConfig(bucket_bytes={bb}),
                              **dict({spec!r}, **kw)))
    hist = run.fit(log_fn=lambda *_: None)
    run.close()
    return [h["loss"] for h in hist]


out = {{"whole": fit(steps={steps})}}
fit(steps={save}, ckpt_dir={ref_dir!r}, ckpt_every={save})
out["from_port"] = fit(steps={steps}, ckpt_dir={port_dir!r})
with open({out!r}, "w") as f:
    json.dump(out, f)
"""


def _port_zero1(init=None, **kw):
    spec = RunSpec(parallel="zero1", mesh=MeshSpec(members_per_device=2),
                   comm=CommConfig(bucket_bytes=BB), **dict(Z_SPEC, **kw))
    with _activations(True), compile_run(spec, device="cpu") as run:
        if init is not None:
            run.params = params_from_numpy(init, "cpu")
            run.opt_state = run.dist_update.plan.init_fn(run.params)
        lines = []
        hist = run.fit(start_step=0 if init is not None else None,
                       log_fn=lines.append)
        return [h["loss"] for h in hist], lines


@pytest.fixture(scope="module")
def zamba2_zero1(tmp_path_factory):
    """The reference's zamba2 zero1 runs at G = 2, from one subprocess on 2
    forced host devices, after the port's run from the reference's initial
    params saved the step-2 checkpoint the reference resumes."""
    tmp = tmp_path_factory.mktemp("zamba2_zero1")
    init = jax.tree.map(np.asarray, jcompile_run(
        JRunSpec(**Z_SPEC)).params)
    dirs = {k: str(tmp / k) for k in ("ref_dir", "port_dir")}
    _port_zero1(init, steps=Z_SAVE, ckpt_dir=dirs["port_dir"],
                ckpt_every=Z_SAVE)
    out = str(tmp / "reference.json")
    code = _ZERO1_REFERENCE.format(spec=Z_SPEC, bb=BB, steps=Z_STEPS,
                                   save=Z_SAVE, out=out, **dirs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True,
                          timeout=REFERENCE_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return dict(json.load(f), init=init, **dirs)


def test_zamba2_bucket_plan_is_the_reference(zamba2_zero1):
    init = zamba2_zero1["init"]
    for G in (2, 4):
        want = jplan_buckets(init, G, BB)
        got = plan_buckets(params_from_numpy(init, "cpu"), G, BB)
        assert len(got.buckets) == len(want.buckets) > 1
        for a, w in zip(got.buckets, want.buckets):
            assert (a.size, a.padded_size) == (w.size, w.padded_size)
            assert [(s.index, tuple(s.shape), s.size, s.offset, s.dtype)
                    for s in a.slots] == \
                [(s.index, tuple(s.shape), s.size, s.offset, s.dtype)
                 for s in w.slots]


def test_zamba2_zero1_fit_matches_reference(zamba2_zero1):
    losses, _ = _port_zero1(zamba2_zero1["init"], steps=Z_STEPS)
    whole = zamba2_zero1["whole"]
    assert len(losses) == len(whole) == 2          # steps 1 and 4 logged
    for a, w in zip(losses, whole):
        assert abs(a - w) <= LOSS_REL * abs(w), (losses, whole)


def test_zamba2_checkpoints_resume_across_packages(zamba2_zero1):
    from repro.checkpoint import ckpt as jckpt
    from repro_torch.checkpoint import ckpt
    # both packages' step-2 files hold the same keys and world meta
    got = ckpt.read_manifest(zamba2_zero1["port_dir"], Z_SAVE)
    want = jckpt.read_manifest(zamba2_zero1["ref_dir"], Z_SAVE)
    assert got["trees"] == want["trees"] and got["meta"] == want["meta"]
    assert any(k.startswith("params:shared/attn/")
               for k in got["trees"]["params"])
    # the reference's checkpoint, resumed in the port
    losses, lines = _port_zero1(steps=Z_STEPS,
                                ckpt_dir=zamba2_zero1["ref_dir"])
    assert any(f"resuming from checkpoint step {Z_SAVE}" in x
               for x in lines), lines
    whole = zamba2_zero1["whole"][-1]
    assert abs(losses[-1] - whole) <= RESUME_TOL, (losses, whole)
    # the port's checkpoint, resumed in the reference
    assert abs(zamba2_zero1["from_port"][-1] - whole) <= RESUME_TOL


# ---------------------------------------------------------------------------
# serving refuses them; the training CLI takes them
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,why", [
    ("xlstm-125m", "attention blocks only"),
    ("zamba2-2.7b", "attention blocks only"),
    ("musicgen-medium", "codebook"),
    ("qwen2-vl-2b", "M-RoPE")])
def test_compile_serve_rejects_them_as_the_reference(arch, why):
    with pytest.raises(ValueError, match=why) as ours:
        compile_serve(ServeSpec(arch=arch, smoke=True), device="cpu")
    with pytest.raises(ValueError) as theirs:
        jcompile_serve(JServeSpec(arch=arch, smoke=True))
    assert str(ours.value) == str(theirs.value)


def test_training_cli_runs_zamba2():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2-2.7b", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "32"], env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "arch: zamba2-2.7b" in proc.stdout
    assert "final loss" in proc.stdout
