"""The port's CNN, configs, data stream, optimizers and schedules against
the JAX package, on the CPU.

Params are the reference's (``jax.random`` init), carried over as numpy
with ``interop.params_from_numpy``; inputs come from numpy with a seed.

Tolerances, each relative to the largest magnitude of what is compared:
- logits and loss, 2e-6: four f32 layers of sums of at most 2048 products,
  taken in different orders by XLA and PyTorch; measured at most 5.2e-7;
- gradients, 5e-6: the backward adds longer sums (a weight gradient sums
  over every pixel of the batch); measured at most 7.6e-7;
- optimizer state and schedules, 1e-6: the same f32 formulas, where XLA may
  fuse a multiply-add that PyTorch rounds twice;
- data batches: bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.data.pipeline import image_stream as jimage_stream  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.params import map_tree  # noqa: E402
from repro_torch.data.pipeline import image_stream  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

ARCHS = ["vgg-a", "overfeat-fast"]
FWD_TOL, GRAD_TOL, OPT_TOL = 2e-6, 5e-6, 1e-6


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _setup(arch, batch=4, seed=0):
    jcfg = jsmoke(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    jparams = jcnn.init_params(jcfg, jax.random.PRNGKey(seed))
    nparams = jax.tree.map(np.asarray, jparams)
    b = next(jimage_stream(jcfg.image_size, jcfg.num_classes, batch, seed))
    return jcfg, cfg, jparams, nparams, b


def _tbatch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) \
        == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke_variant(get_config(arch))) \
        == dataclasses.asdict(jsmoke(jget_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_init(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs, jspecs = cnn.param_specs(cfg), jcnn.param_specs(jcfg)
    assert list(specs) == list(jspecs)
    assert {k: s.shape for k, s in specs.items()} \
        == {k: s.shape for k, s in jspecs.items()}
    # sorted key order is forward layer order (conv02 before conv10)
    idx = [int(k[-4:-2]) if k.startswith("conv") else int(k[2:4])
           for k in sorted(specs)]
    assert idx == sorted(idx)
    params = cnn.init_params(smoke_variant(cfg), seed=1, device="cpu")
    for k, p in params.items():
        if k.endswith("_b"):
            assert not p.any()
        else:   # the reference's fan-in: shape[-2] (IFM for HWIO)
            assert abs(p.std().item() * np.sqrt(p.shape[-2]) - 1) < 0.2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(arch, use_kernel):
    jcfg, cfg, jparams, nparams, b = _setup(arch)
    want = jcnn.forward(jparams, jcfg, jnp.asarray(b["images"]),
                        use_pallas=use_kernel)
    params = params_from_numpy(nparams, "cpu")
    got = cnn.forward(params, cfg, torch.tensor(b["images"]),
                      use_kernel=use_kernel)
    assert got.shape == (4, cfg.num_classes)
    _close(got.numpy(), want, FWD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_loss_and_grads_match_jax_grad(arch, use_kernel):
    """Both routes against ``jax.grad`` of the reference's default route:
    ``jax.grad`` through the Pallas conv raises under jax 0.9.0, and the
    kernel route's backward is the gradient of ``conv2d_ref`` by design."""
    jcfg, cfg, jparams, nparams, b = _setup(arch, seed=3)
    jb = jax.tree.map(jnp.asarray, b)
    jloss, jgrads = jax.value_and_grad(jcnn.loss_fn)(jparams, jcfg, jb)
    params = map_tree(lambda t: t.requires_grad_(),
                      params_from_numpy(nparams, "cpu"))
    loss = cnn.loss_fn(params, cfg, _tbatch(b), use_kernel=use_kernel)
    keys = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    _close(loss.item(), float(jloss), FWD_TOL)
    for k, g in zip(keys, grads):
        _close(g.numpy(), jgrads[k], GRAD_TOL)


@pytest.mark.parametrize("image_size,batch", [(32, 8), (224, 2)])
def test_image_stream_is_bitwise_the_reference(image_size, batch):
    ours = image_stream(image_size, 16, batch, seed=5)
    ref = jimage_stream(image_size, 16, batch, seed=5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _opt_run(jopt, topt, steps=4, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a_w": (3, 3, 4, 8), "b_b": (8,), "c_w": (16, 5)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    gs = [{k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()} for _ in range(steps)]
    lrs = [1e-2, 2e-2, 5e-3, 1e-2][:steps]
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = params_from_numpy(p0, "cpu")
    ts = topt.init(tp)
    for g, lr in zip(gs, lrs):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.float32(lr))
        tp, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp, lr)
    return jp, js, tp, ts


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_momentum_sgd_matches_reference(wd):
    jp, js, tp, ts = _opt_run(joptim.MomentumSGD(0.9, wd),
                              toptim.MomentumSGD(0.9, wd))
    for k in tp:
        _close(tp[k].numpy(), jp[k], OPT_TOL)
        _close(ts.velocity[k].numpy(), js.velocity[k], OPT_TOL)


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adamw_matches_reference(wd):
    jp, js, tp, ts = _opt_run(joptim.AdamW(weight_decay=wd),
                              toptim.AdamW(weight_decay=wd))
    assert ts.count == int(js.count) == 4
    for k in tp:
        _close(tp[k].numpy(), jp[k], OPT_TOL)
        _close(ts.mu[k].numpy(), js.mu[k], OPT_TOL)
        _close(ts.nu[k].numpy(), js.nu[k], OPT_TOL)


@pytest.mark.parametrize("name,args", [
    ("constant", (5e-3,)),
    ("warmup_cosine", (1e-3, 3, 20)),
    ("warmup_cosine", (2e-3, 1, 7, 0.2)),
    ("linear_scale_warmup", (1e-3, 4, 3, 20)),
    ("linear_scale_warmup", (1e-3, 1, 0, 9)),
])
def test_schedules_match_reference(name, args):
    ours, ref = getattr(toptim, name)(*args), getattr(joptim, name)(*args)
    for step in range(24):
        got = ours(step)
        assert isinstance(got, float)
        _close(got, float(ref(step)), OPT_TOL)
