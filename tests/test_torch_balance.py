"""The port's §3 balance model (``repro_torch.core.balance``) against the
reference's (``repro.core.balance``), function by function.

Both modules are the same arithmetic on Python floats in the same order
(``math`` and ``dataclasses`` only; the reference module imports no JAX),
so every result must be **exactly** the reference's: ``==`` on floats,
ints, tuples and dicts, ``dataclasses.asdict`` on hardware configs.  The
inputs are the reference's own: the conv and FC layers of VGG-A and
OverFeat-FAST, CD-DNN's products, Table 1's platforms (and the port's
H100), both cross-host regimes, every collective backend and wire format,
and G in {1, 2, 4, 16, 64}.
"""
import dataclasses
import math

import pytest

pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import balance as jb  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import balance as tb  # noqa: E402

GS = (1, 2, 4, 16, 64)
PLATFORMS = ("XEON_E5_2698V3_FDR", "XEON_E5_2666V3_10GBE", "XEON_E5_2697V3",
             "TPU_V5E", "H100_SXM")
CNNS = ("vgg-a", "overfeat-fast")
BACKENDS = tuple(jb.RING_BACKEND_MODELS)
FORMATS = ("fp32", "bf16", "int8", "topk")
# (dense gradient bytes, tensors): VGG-A's full width, CD-DNN's, a small tree
TREES = ((4 * 132_863_336, 22), (4 * 48_245_848, 16), (4 * 1_000, 3))
BUCKETS = (0, 64 * 1024, 4 * 2 ** 20, 25 * 2 ** 20)


def _hw(name):
    """(port, reference) HardwareConfig of one platform; the port's H100
    rebuilt in the reference's class."""
    t = getattr(tbase, name)
    j = getattr(jbase, name, None) or jbase.HardwareConfig(
        **dataclasses.asdict(t))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


def _layers(arch, kind):
    t = [lyr for lyr in get_config(arch).layers if lyr.kind == kind]
    j = [lyr for lyr in jget_config(arch).layers if lyr.kind == kind]
    assert [dataclasses.asdict(x) for x in t] == \
        [dataclasses.asdict(x) for x in j]
    return list(zip(t, j))


def _same_hw(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _dnn_dims():
    c = get_config("cd-dnn")
    return ([(c.input_dim, c.hidden_dim)]
            + [(c.hidden_dim, c.hidden_dim)] * (c.num_hidden - 1)
            + [(c.hidden_dim, c.output_dim)])


@pytest.mark.parametrize("mb", [1, 32, 256])
@pytest.mark.parametrize("arch", CNNS)
def test_data_parallel_layer_forms(arch, mb):
    for t, j in _layers(arch, "conv") + _layers(arch, "fc"):
        assert tb.conv_comp_flops(t, mb) == jb.conv_comp_flops(j, mb)
        assert tb.data_parallel_comp_comm_ratio(t, mb) == \
            jb.data_parallel_comp_comm_ratio(j, mb)
        in_hw = max(t.out_hw * t.stride, 1)
        for overlap in (0.0, 0.5, 1.0):
            for size in (4, 2):
                assert tb.data_parallel_comm_bytes(t, overlap, size) == \
                    jb.data_parallel_comm_bytes(j, overlap, size)
            assert tb.model_parallel_preferred(t, in_hw, mb, overlap) == \
                jb.model_parallel_preferred(j, in_hw, mb, overlap)
        assert tb.model_parallel_comm_bytes(t.ifm, in_hw, mb) == \
            jb.model_parallel_comm_bytes(j.ifm, in_hw, mb)


@pytest.mark.parametrize("overlap", [0.0, 1.0])
@pytest.mark.parametrize("mb", [1, 256])
@pytest.mark.parametrize("arch", CNNS)
def test_aggregate_comp_comm_ratio(arch, mb, overlap):
    pairs = _layers(arch, "conv")
    assert tb.aggregate_comp_comm_ratio([t for t, _ in pairs], mb, overlap) \
        == jb.aggregate_comp_comm_ratio([j for _, j in pairs], mb, overlap)


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("mb", [64, 256, 1024])
def test_fc_and_hybrid_forms(mb, G):
    fcs = [(x.ifm, x.ofm) for arch in CNNS
           for x, _ in _layers(arch, "fc")] + _dnn_dims()
    for ifm, ofm in fcs:
        assert tb.fc_comp_flops(ifm, ofm, mb) == jb.fc_comp_flops(ifm, ofm, mb)
        for N in (G, 4 * G, 64):
            for overlap in (0.0, 0.5):
                assert tb.hybrid_comm_bytes(ifm, ofm, 1, 1, mb, G, N,
                                            overlap) == \
                    jb.hybrid_comm_bytes(ifm, ofm, 1, 1, mb, G, N, overlap)
            assert tb.optimal_group_count(N, mb, ofm) == \
                jb.optimal_group_count(N, mb, ofm)
            assert tb.hybrid_comm_at_optimum(ifm, ofm, mb, N) == \
                jb.hybrid_comm_at_optimum(ifm, ofm, mb, N)
    # a conv layer under hybrid parallelism (kernel and input size > 1)
    for t, j in _layers("vgg-a", "conv"):
        assert tb.hybrid_comm_bytes(t.ifm, t.ofm, t.kernel, t.out_hw, mb, G,
                                    64, 1.0) == \
            jb.hybrid_comm_bytes(j.ifm, j.ofm, j.kernel, j.out_hw, mb, G, 64,
                                 1.0)


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("arch", CNNS)
def test_max_data_parallel_nodes_and_bubbles(arch, platform):
    thw, jhw = _hw(platform)
    pairs = _layers(arch, "conv")
    tl = [tb.LayerBalance(f"c{i}", tb.conv_comp_flops(t, 1),
                          tb.data_parallel_comm_bytes(t))
          for i, (t, _) in enumerate(pairs)]
    jl = [jb.LayerBalance(f"c{i}", jb.conv_comp_flops(j, 1),
                          jb.data_parallel_comm_bytes(j))
          for i, (_, j) in enumerate(pairs)]
    for mb in (32, 256, 1024):
        assert tb.max_data_parallel_nodes(tl, thw, mb) == \
            jb.max_data_parallel_nodes(jl, jhw, mb)
    assert tb.bubble_schedule(tl, thw, 0.75) == \
        jb.bubble_schedule(jl, jhw, 0.75)
    assert tb.scaling_efficiency(tl, thw) == jb.scaling_efficiency(jl, jhw)


def test_backend_models_and_regimes_are_the_reference_constants():
    assert {k: dataclasses.asdict(v)
            for k, v in tb.RING_BACKEND_MODELS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jb.RING_BACKEND_MODELS.items()}
    assert tb.CROSS_HOST_REGIMES == jb.CROSS_HOST_REGIMES
    assert tb.WIRE_FORMAT_BYTES == jb.WIRE_FORMAT_BYTES
    assert (tb.INT8_SCALE_BYTES, tb.TOPK_ENTRY_BYTES, tb.SIZE_F32) == \
        (jb.INT8_SCALE_BYTES, jb.TOPK_ENTRY_BYTES, jb.SIZE_F32)
    thw, jhw = _hw("XEON_E5_2698V3_FDR")
    for mod, hw in ((tb, thw), (jb, jhw)):
        with pytest.raises(ValueError):
            mod.cross_host_hw(hw, "carrier-pigeon")
        with pytest.raises(ValueError):
            mod.backend_hw(hw, "nccl")
        with pytest.raises(ValueError):
            mod.wire_bytes_per_element("fp8")


@pytest.mark.parametrize("platform", PLATFORMS)
def test_cross_host_and_backend_hw(platform):
    thw, jhw = _hw(platform)
    for regime in tb.CROSS_HOST_REGIMES:
        _same_hw(tb.cross_host_hw(thw, regime), jb.cross_host_hw(jhw, regime))
    for backend in BACKENDS:
        _same_hw(tb.backend_hw(thw, backend), jb.backend_hw(jhw, backend))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("platform", PLATFORMS)
def test_ring_and_bucketed_collective_times(platform, G, backend):
    thw, jhw = _hw(platform)
    for total, n in TREES:
        assert tb.ring_collective_time(total, G, thw, backend) == \
            jb.ring_collective_time(total, G, jhw, backend)
        for bucket in BUCKETS:
            assert tb.collective_count(total, n, bucket) == \
                jb.collective_count(total, n, bucket)
            for n_coll, fill in ((0, 0.0), (14, 4.0 * 102_760_448)):
                assert tb.bucketed_allreduce_time(
                    total, n, bucket, G, thw, n_coll, fill, backend) == \
                    jb.bucketed_allreduce_time(total, n, bucket, G, jhw,
                                               n_coll, fill, backend)
            assert tb.gossip_exchange_time(total, n, bucket, G, thw,
                                           backend=backend) == \
                jb.gossip_exchange_time(total, n, bucket, G, jhw,
                                        backend=backend)
            assert tb.gossip_exchange_time(total, n, bucket, G, thw, 14) == \
                jb.gossip_exchange_time(total, n, bucket, G, jhw, 14)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("platform", PLATFORMS)
def test_wire_format_models(platform, G, fmt):
    thw, jhw = _hw(platform)
    for ratio in (0.01, 0.05, 0.25):
        assert tb.wire_bytes_per_element(fmt, ratio) == \
            jb.wire_bytes_per_element(fmt, ratio)
        assert tb.wire_reduce_factor(fmt, ratio) == \
            jb.wire_reduce_factor(fmt, ratio)
        for total, n in TREES:
            assert tb.optimal_bucket_bytes(total, G, thw, fmt, ratio) == \
                jb.optimal_bucket_bytes(total, G, jhw, fmt, ratio)
            for n_coll in (1, 14, 97):
                assert tb.wire_reduce_bytes(total, G, n_coll, fmt, ratio) == \
                    jb.wire_reduce_bytes(total, G, n_coll, fmt, ratio)
            for bucket in BUCKETS:
                for backend in BACKENDS:
                    assert tb.compressed_allreduce_time(
                        total, n, bucket, G, thw, fmt, ratio,
                        backend=backend) == jb.compressed_allreduce_time(
                        total, n, bucket, G, jhw, fmt, ratio,
                        backend=backend)
                assert tb.compressed_allreduce_time(
                    total, n, bucket, G, thw, fmt, ratio, 14, 1e6) == \
                    jb.compressed_allreduce_time(total, n, bucket, G, jhw,
                                                 fmt, ratio, 14, 1e6)


@pytest.mark.parametrize("regime", sorted(jb.CROSS_HOST_REGIMES))
@pytest.mark.parametrize("g_in,g_out", [(1, 2), (2, 2), (4, 4), (8, 8),
                                        (16, 4), (64, 1)])
def test_hierarchical_allreduce_time(g_in, g_out, regime):
    thw, jhw = _hw("XEON_E5_2698V3_FDR")
    thw, jhw = tb.cross_host_hw(thw, regime), jb.cross_host_hw(jhw, regime)
    for total, n in TREES:
        for bucket in BUCKETS:
            for pod_bw in (0.0, 450e9):
                for backend in BACKENDS:
                    for cross in ("lax", "pallas-ring"):
                        kw = dict(pod_bw=pod_bw, backend=backend,
                                  cross_backend=cross)
                        assert tb.hierarchical_allreduce_time(
                            total, n, bucket, g_in, g_out, thw, **kw) == \
                            jb.hierarchical_allreduce_time(
                                total, n, bucket, g_in, g_out, jhw, **kw)
            assert tb.hierarchical_allreduce_time(
                total, n, bucket, g_in, g_out, thw, n_coll=14,
                fill_bytes=1e6) == jb.hierarchical_allreduce_time(
                total, n, bucket, g_in, g_out, jhw, n_coll=14,
                fill_bytes=1e6)


def test_stale_sync_exposed_time():
    for comm in (0.0, 1e-3, 0.25, 3.0):
        for comp in (0.0, 1e-3, 0.5):
            assert tb.stale_sync_exposed_time(comm, comp) == \
                jb.stale_sync_exposed_time(comm, comp)


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("nodes", [1, 2, 4, 16, 64])
@pytest.mark.parametrize("arch", CNNS)
def test_network_balance(arch, nodes, platform):
    thw, jhw = _hw(platform)
    conv, fc = _layers(arch, "conv"), _layers(arch, "fc")
    for mb in (256, 1024):
        for eff, overlap in ((0.75, 1.0), (0.5, 0.5)):
            got = tb.network_balance([t for t, _ in conv], [t for t, _ in fc],
                                     mb, nodes, thw, eff, overlap)
            want = jb.network_balance([j for _, j in conv],
                                      [j for _, j in fc], mb, nodes, jhw,
                                      eff, overlap)
            assert got == want
            assert all(math.isfinite(v) for v in got.values())


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("nodes", [1, 2, 4, 16, 64])
def test_dnn_hybrid_scaling(nodes, platform):
    thw, jhw = _hw(platform)
    c = get_config("cd-dnn")
    for mb in (256, 1024):
        for eff in (0.6, 0.9):
            assert tb.dnn_hybrid_scaling(
                c.input_dim, c.hidden_dim, c.num_hidden, c.output_dim, mb,
                nodes, thw, eff) == jb.dnn_hybrid_scaling(
                c.input_dim, c.hidden_dim, c.num_hidden, c.output_dim, mb,
                nodes, jhw, eff)
