"""The port's §2.2 blocking solver (``repro_torch.core.blocking``) and
hardware table against the JAX package's, on the CPU.

The solvers are pure integer and float arithmetic in the same order, so
every field of every choice must be equal (no tolerance); the paper's
anchors are the reference's own tests (``tests/test_blocking.py``).  The
H100 preset's tiles at CD-DNN's three layer shapes are pinned: they decide
which kernel instances the card's training path runs.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import blocking as jblocking  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import blocking  # noqa: E402
from repro_torch.kernels.blocked_matmul import kernel_tile  # noqa: E402

DIMS = [1, 7, 8, 64, 100, 128, 256, 440, 1024, 2048, 4096, 9304]


def _same(got, want):
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@given(m=st.sampled_from(DIMS), n=st.sampled_from(DIMS),
       k=st.sampled_from(DIMS),
       vmem=st.sampled_from([64 * 1024, 2 * 2**20, 8 * 2**20]),
       size=st.sampled_from([2, 4]))
@settings(max_examples=40, deadline=None)
def test_gemm_solver_equals_reference(m, n, k, vmem, size):
    try:
        want = jblocking.solve_gemm_blocking(m, n, k, vmem_bytes=vmem,
                                             size_data=size)
    except AssertionError:      # no candidate fits: the port raises
        with pytest.raises(ValueError, match="no .* blocking fits"):
            blocking.solve_gemm_blocking(m, n, k, vmem_bytes=vmem,
                                         size_data=size)
        return
    _same(blocking.solve_gemm_blocking(m, n, k, vmem_bytes=vmem,
                                       size_data=size), want)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("align,cap", [(8, 512), (128, 2048), (16, None)])
def test_candidates_equal_reference(dim, align, cap):
    assert blocking._candidates(dim, align, cap) \
        == jblocking._candidates(dim, align, cap)


@pytest.mark.parametrize("args", [
    (1, 512, 1024, 12, 3, 1, 128 * 1024, 4, 16),     # OverFeat C5
    (1, 256, 512, 28, 3, 1, 128 * 1024, 4, 16),      # VGG-A conv4
    (4, 512, 512, 14, 3, 1, 8 * 2**20, 4, 128),      # VGG-A conv5
    (2, 3, 96, 56, 11, 4, 8 * 2**20, 4, 128),        # OverFeat conv1
    (8, 64, 128, 112, 3, 1, 2 * 2**20, 2, 128),
])
def test_conv_solver_equals_reference(args):
    _same(blocking.solve_conv_blocking(*args),
          jblocking.solve_conv_blocking(*args))


@pytest.mark.parametrize("args", [(12, 3), (12, 3, 2), (56, 3, 1, 2),
                                  (7, 11, 4)])
def test_layer_bf_unblocked_equals_reference(args):
    assert blocking.layer_bf_unblocked(*args) \
        == jblocking.layer_bf_unblocked(*args)


@pytest.mark.parametrize("args", [(256, 512, 1024, 12, 3),
                                  (1, 3, 64, 224, 3), (64, 512, 512, 14, 3)])
def test_layer_bf_fully_cached_equals_reference(args):
    assert blocking.layer_bf_fully_cached(*args) \
        == jblocking.layer_bf_fully_cached(*args)
    assert blocking.conv_block_bytes(*args, 1, 1) \
        == jblocking.conv_block_bytes(*args, 1, 1)
    assert blocking.conv_block_flops(*args, 2) \
        == jblocking.conv_block_flops(*args, 2)


def test_paper_anchors():
    """Paper §2.2: OverFeat-FAST C5 row-at-a-time B/F 0.54; fully cached at
    minibatch 256 below 0.004, over 100x lower."""
    assert blocking.layer_bf_unblocked(12, 3) == pytest.approx(0.54,
                                                               abs=0.02)
    cached = blocking.layer_bf_fully_cached(256, 512, 1024, 12, 3)
    assert cached < 0.004
    assert blocking.layer_bf_unblocked(12, 3) / cached > 100


@pytest.mark.parametrize("name", ["TPU_V5E", "XEON_E5_2698V3_FDR",
                                  "XEON_E5_2666V3_10GBE", "XEON_E5_2697V3"])
def test_hardware_entries_equal_reference(name):
    _same(getattr(base, name), getattr(jbase, name))


def test_h100_entry_is_the_data_sheet():
    h = base.H100_SXM
    assert (h.peak_flops, h.mem_bw, h.link_bw, h.cache_bytes) \
        == (67e12, 3.35e12, 450e9, 232_448)


@pytest.mark.parametrize("shape,tile", [
    ((1024, 2048, 440), (128, 128, 8)),     # fc00: 440 -> 2048
    ((1024, 2048, 2048), (128, 128, 8)),    # fc01-fc06: 2048 -> 2048
    ((1024, 9304, 2048), (128, 64, 8)),     # fc07: 2048 -> 9304
], ids=["fc00", "hidden", "fc07"])
def test_h100_preset_at_cd_dnn_shapes(shape, tile):
    M, N, K = shape
    blk = blocking.solve_h100_gemm_blocking(M, N, K)
    assert (blk.bm, blk.bn, blk.bk) == tile
    assert blk.bytes_per_block <= base.H100_SXM.cache_bytes
    assert kernel_tile(blk, M, N, K) == tile


@given(m=st.sampled_from(DIMS), n=st.sampled_from(DIMS),
       k=st.sampled_from(DIMS), size=st.sampled_from([2, 4]))
@settings(max_examples=40, deadline=None)
def test_h100_preset_always_has_a_kernel_instance(m, n, k, size):
    blk = blocking.solve_h100_gemm_blocking(m, n, k, size_data=size)
    bm, bn, bk = kernel_tile(blk, m, n, k)
    assert bm in blocking.H100_GEMM_TILES_MN
    assert bn in blocking.H100_GEMM_TILES_MN
    assert bk == blocking.H100_GEMM_TILE_K
