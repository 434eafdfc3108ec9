"""The transformer family's model ways in the port (``compile_run`` of every
LM at ``{data: 2, model: 2}`` under dp, and LM checkpoints across packages
and model ways) against the JAX package, on the CPU.  The other modes are
``tests/test_torch_lm_model_modes.py``'s.

The reference runs on 4 forced host devices (``MeshSpec(model_ways=2)``),
in subprocesses started together when this module begins, so that they run
while the module's port runs do:

- ``dp0`` - ``dp2``: every arch of ``ASSIGNED_ARCHS`` (smoke) under dp, 2
  steps, in the tests' order;
- ``ckpt``: llama3-8b's dp checkpoints written at model_ways 2 and 1, and
  the port's, written at 2 and 1, resumed at 1 and 2.

Every run is momentum SGD at lr 1e-2 on a constant schedule, batch 8 x 32
tokens.  The port starts from the reference's params
(``Run.load_params``); both packages draw the same batches from the seeded
streams.

Tolerances (``tests/test_torch_hybrid.py``'s for the LMs): losses within
1e-3 relative and grad norms within 1e-2 (bf16 activations round at other
places in the two frameworks); zamba2 and xlstm on f32 activations in both
packages, as that file fits them.  Checkpoints: keys and full shapes equal
to the reference's; a resumed run's losses within 1e-3 relative of an
uninterrupted run in the other package from the same seed.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_hybrid import (  # noqa: E402
    F32_ARCHS,
    _leaves,
    _quiet,
    _Reference,
    _tree,
)
from repro_torch.api import MeshSpec, RunSpec, compile_run  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.core.params import tree_leaves  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

LOSS_REL, GNORM_REL = 1e-3, 1e-2
KW = dict(optimizer="sgd", lr=1e-2)
CKPT_ARCH = "llama3-8b"
DP_PARTS = (ASSIGNED_ARCHS[:3], ASSIGNED_ARCHS[3:6], ASSIGNED_ARCHS[6:])


def _spec(arch, parallel, model_ways=2, **kw):
    """The port's RunSpec of a reference case on 4 devices."""
    comm = CommConfig(backend="pallas-ring") if parallel == "zero1" \
        else None
    base = dict(arch=arch, smoke=True, steps=2, batch=8, seq=32,
                schedule="constant", log_every=1, **KW)
    base.update(kw)
    return RunSpec(parallel=parallel, comm=comm,
                   mesh=MeshSpec(members_per_device=4 // model_ways,
                                 model_ways=model_ways), **base)


def _record(arch, mode, **kw):
    extra = "".join(f", {k}={v!r}" for k, v in {**KW, **kw}.items())
    return f"record('{arch}/{mode}', spec('{arch}', '{mode}', 2{extra}))\n"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lm_model_ref"))
    ref = _Reference(root)
    ref.ckpt_root = os.path.join(root, "ckpt")
    for i, archs in enumerate(DP_PARTS):
        ref.start(f"dp{i}", "".join(_record(a, "dp") for a in archs))
    # the port writes its checkpoints, then the reference writes its own
    # and resumes the port's at the other model ways
    for w in (2, 1):
        with compile_run(_spec(CKPT_ARCH, "dp", w, ckpt_every=2, ckpt_dir=(
                os.path.join(ref.ckpt_root, f"port-{w}"))),
                device="cpu") as run:
            run.fit(log_fn=_quiet)
    body = ""
    for w in (2, 1):
        d = os.path.join(ref.ckpt_root, f"ref-{w}")
        body += (f"record('ref/{w}', spec('{CKPT_ARCH}', 'dp', {w}, "
                 f"ckpt_every=2, ckpt_dir={d!r}, optimizer='sgd', "
                 f"lr=1e-2))\n")
        body += (f"record('refall/{w}', spec('{CKPT_ARCH}', 'dp', {w}, "
                 f"steps=4, optimizer='sgd', lr=1e-2))\n")
    for a, b in ((2, 1), (1, 2)):
        dst = os.path.join(ref.ckpt_root, f"jresume-{a}-{b}")
        shutil.copytree(os.path.join(ref.ckpt_root, f"port-{a}"), dst)
        body += (f"record('resume/{a}/{b}', spec('{CKPT_ARCH}', 'dp', {b}, "
                 f"steps=4, ckpt_every=2, ckpt_dir={dst!r}, "
                 f"optimizer='sgd', lr=1e-2))\n")
    ref.start("ckpt", body)
    yield ref
    ref.close()


def _port_fit(spec, p0):
    with compile_run(spec, device="cpu") as run:
        run.load_params(_tree(run, p0))
        hist = run.fit(log_fn=_quiet)
        return run, hist


def _check_run(reference, name, arch, mode, monkeypatch):
    arrays, _ = reference.get(name)
    tag = f"{arch}/{mode}"
    if arch in F32_ARCHS:
        from repro_torch.models import transformer
        monkeypatch.setattr(transformer, "ACTIVATION_DTYPE", torch.float32)
    run, hist = _port_fit(_spec(arch, mode), _leaves(arrays, tag, "p0"))
    assert run.mesh.shape == {"data": 2, "model": 2}
    # the params in member layout: a model-sharded leaf carries the model
    # members' dim first
    specs = tree_leaves(run.family.param_specs(run.cfg))
    sharded = [s for s in specs if run.ctx.sharded(s)]
    assert sharded, f"{arch}: no leaf on the model axis"
    np.testing.assert_allclose([h["loss"] for h in hist],
                               arrays[f"{tag}/loss"], rtol=LOSS_REL)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               arrays[f"{tag}/gnorm"], rtol=GNORM_REL)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_dp_matches_the_reference_for_every_arch(reference, arch,
                                                 monkeypatch):
    part = next(i for i, a in enumerate(DP_PARTS) if arch in a)
    _check_run(reference, f"dp{part}", arch, "dp", monkeypatch)


# ---------------------------------------------------------------------------
# checkpoints across packages and model ways
# ---------------------------------------------------------------------------
def test_lm_checkpoint_files_are_the_reference(reference):
    reference.get("ckpt")
    for w in (2, 1):
        files = {}
        for who in ("ref", "port"):
            d = os.path.join(reference.ckpt_root, f"{who}-{w}")
            with np.load(os.path.join(d, "ckpt_00000002.npz")) as z:
                files[who] = {k: z[k].shape for k in z.files}
        assert files["port"] == files["ref"]


def _uninterrupted_losses(model_ways):
    with compile_run(_spec(CKPT_ARCH, "dp", model_ways, steps=4),
                     device="cpu") as run:
        return [h["loss"] for h in run.fit(log_fn=_quiet)]


@pytest.mark.parametrize("a,b", [(2, 1), (1, 2)])
def test_lm_checkpoints_resume_across_packages_and_model_ways(reference, a,
                                                              b, tmp_path):
    arrays, _ = reference.get("ckpt")
    # the reference's checkpoint, resumed by the port at the other ways
    shutil.copytree(os.path.join(reference.ckpt_root, f"ref-{a}"),
                    tmp_path / "c")
    with compile_run(_spec(CKPT_ARCH, "dp", b, steps=4, ckpt_every=2,
                           ckpt_dir=str(tmp_path / "c")),
                     device="cpu") as run:
        hist = run.fit(log_fn=_quiet)
    assert [h["step"] for h in hist] == [3, 4]
    assert ckpt.latest_step(str(tmp_path / "c")) == 4
    # against the reference's uninterrupted run at the checkpoint's ways
    np.testing.assert_allclose([h["loss"] for h in hist],
                               arrays[f"refall/{a}/loss"][2:],
                               rtol=LOSS_REL)
    # the port's checkpoint, resumed by the reference at the other ways,
    # against the port's uninterrupted run from the same seed
    got = arrays[f"resume/{a}/{b}/loss"]
    assert len(got) == 2
    np.testing.assert_allclose(got, _uninterrupted_losses(b)[2:],
                               rtol=LOSS_REL)
