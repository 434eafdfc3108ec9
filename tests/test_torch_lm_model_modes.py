"""The transformer family's model ways under the zero1 and relaxed modes
(``compile_run`` at ``{data: 2, model: 2}``) against the JAX package, on
the CPU; dp and the checkpoints are ``tests/test_torch_lm_model_ways.py``'s,
whose helpers and tolerances this file shares.

The reference runs on 4 forced host devices, in six subprocesses started
together when this module begins, one an arch: zero1-gspmd and zero1
(pallas-ring: the §3.4 update on full leaves over the data members) for
llama3-8b, gemma-2b (MQA: 4 q heads, 1 kv head), qwen2-moe-a2.7b,
mixtral-8x22b and xlstm-125m (smoke), 2 steps, and stale-sync and gossip
for llama-100m.

Tolerances: losses within 1e-3 relative and grad norms within 1e-2 (bf16
activations round at other places in the two frameworks); xlstm on f32
activations in both packages.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_hybrid import _Reference  # noqa: E402
from test_torch_lm_model_ways import _check_run, _record  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

MODE_ARCHS = ("llama3-8b", "gemma-2b", "qwen2-moe-a2.7b", "mixtral-8x22b",
              "xlstm-125m")
RELAXED = ("stale-sync", "gossip")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(str(tmp_path_factory.mktemp("lm_modes_ref")))
    for arch in MODE_ARCHS:
        ref.start(arch, "".join(_record(arch, m)
                                for m in ("zero1-gspmd", "zero1")))
    ref.start("relaxed", "".join(_record("llama-100m", m) for m in RELAXED))
    yield ref
    ref.close()


@pytest.mark.parametrize("mode", ["zero1-gspmd", "zero1"])
@pytest.mark.parametrize("arch", MODE_ARCHS)
def test_zero1_modes_match_the_reference(reference, arch, mode,
                                         monkeypatch):
    _check_run(reference, arch, arch, mode, monkeypatch)


@pytest.mark.parametrize("mode", RELAXED)
def test_relaxed_modes_match_the_reference(reference, mode, monkeypatch):
    _check_run(reference, "relaxed", "llama-100m", mode, monkeypatch)
