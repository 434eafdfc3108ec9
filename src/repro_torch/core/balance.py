"""Paper §3 — the computation/communication balance of synchronous SGD
(``repro.core.balance``, formula for formula).

All comp quantities are FLOPs, all comm quantities bytes, all times
seconds; ``hw`` is a :class:`~repro_torch.configs.base.HardwareConfig` (the
port's ``H100_SXM`` or the paper's platforms).  The module is pure
arithmetic in the reference's order on Python floats (``math`` and
``dataclasses`` only), so each function returns the reference's float
exactly:

  * §3.1 data parallelism: per-layer comp and comm, Table 1's comp/comm
    ratios, the bubble schedule of the backprop overlap and its
    fusion-bucket form (``issue_order`` is the one ordering rule of the
    overlap: ``comm.bucketer.BucketPlan.backprop_order`` and
    ``comm.overlap`` use it, so the closed forms and the executable
    schedule cannot disagree on order), and the node bound;
  * §3.2 model parallelism and §3.3 hybrid parallelism (the optimal group
    count);
  * the collective cost models: the ring, bucketed, compressed-wire and
    hierarchical all-reduce times, the optimal bucket size
    (``telemetry.autotune`` fits their constants on the live mesh), and
    the relaxed modes' gossip exchange and stale-sync exposure;
  * the whole-network scaling models behind Figs. 4, 6 and 7.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.configs.base import ConvLayerSpec, HardwareConfig

SIZE_F32 = 4


# ---------------------------------------------------------------------------
# §3.1 data parallelism — per-layer comp and comm
# ---------------------------------------------------------------------------
def conv_comp_flops(lyr: ConvLayerSpec, mb_node: int) -> float:
    """Paper §3.1: Comp = 3*2*MB_node*ifm*ofm*k_w*k_h*out_w*out_h
    (forward + backprop + weight-gradient, each 2*MACs)."""
    return (3.0 * 2.0 * mb_node * lyr.ifm * lyr.ofm * lyr.kernel
            * lyr.kernel * lyr.out_hw * lyr.out_hw)


def fc_comp_flops(ifm: int, ofm: int, mb_node: int) -> float:
    """FC = conv with k=out=1 (paper §2.1)."""
    return 3.0 * 2.0 * mb_node * ifm * ofm


def data_parallel_comm_bytes(lyr: ConvLayerSpec, overlap: float = 1.0,
                             size_data: int = SIZE_F32) -> float:
    """Paper §3.1: Comm = size_data*ifm*ofm*k_w*k_h*(2-overlap).
    (send partial weight gradients + receive updated weights; overlap=1
    means sends/receives fully overlap each other.)"""
    k = max(lyr.kernel, 1)
    return size_data * lyr.ifm * lyr.ofm * k * k * (2.0 - overlap)


def data_parallel_comp_comm_ratio(lyr: ConvLayerSpec, mb_node: int) -> float:
    """Paper §3.1 closed form: comp_comm = 1.5*out_w*out_h*MB_node
    (FP32, overlap=1).  Independent of kernel size, ifm, ofm, stride."""
    return 1.5 * lyr.out_hw * lyr.out_hw * mb_node


def aggregate_comp_comm_ratio(layers: Sequence[ConvLayerSpec],
                              mb_node: int = 1, overlap: float = 1.0) -> float:
    """Network-level comp-to-comm for the data-parallel regime: total conv
    FLOPs per node / total gradient+weight bytes.  The paper quotes 208 for
    OverFeat-FAST and 1456 for VGG-A conv layers."""
    comp = sum(conv_comp_flops(lyr, mb_node) for lyr in layers)
    comm = sum(data_parallel_comm_bytes(lyr, overlap) for lyr in layers)
    return comp / comm


# ---------------------------------------------------------------------------
# §3.1 overlap / bubble model
# ---------------------------------------------------------------------------
@dataclass
class LayerBalance:
    name: str
    comp: float    # FLOPs per node per iteration (3 passes)
    comm: float    # bytes per node per iteration (data-parallel volume)


def bubble_schedule(layers: Sequence[LayerBalance], hw: HardwareConfig,
                    efficiency: float = 1.0) -> List[float]:
    """Paper §3.1:
        ocomp_i  = sum_{j<i} comp_j + comp_i/3
        ocomms_i = sum_{j<=i} comms_j
        bubble_i = ocomms_i/comms_sys - ocomp_i/comp_sys
    Layers in forward order; layer i's communication, issued right after
    its weight gradient, overlaps the backprop of layers j < i and layer
    i's own input-gradient pass (the comp_i/3 term).  Per-layer bubbles in
    seconds, negative when fully hidden."""
    comp_sys = hw.peak_flops * efficiency
    bubbles = []
    for i, li in enumerate(layers):
        ocomp = sum(lyr.comp for lyr in layers[:i]) + li.comp / 3.0
        ocomms = sum(lyr.comm for lyr in layers[: i + 1])
        bubbles.append(ocomms / hw.link_bw - ocomp / comp_sys)
    return bubbles


def issue_order(triggers: Sequence[int]) -> Tuple[int, ...]:
    """Bucket indices in backprop issue order: descending trigger layer (a
    bucket completed by a later layer is ready earlier in backprop), ties
    toward the later tree-order bucket."""
    return tuple(sorted(range(len(triggers)),
                        key=lambda b: (triggers[b], b), reverse=True))


def bucket_bubble_schedule(comm_times: Sequence[float],
                           triggers: Sequence[int],
                           layer_comps: Sequence[float],
                           hw: HardwareConfig,
                           efficiency: float = 1.0) -> List[float]:
    """The §3.1 bubble schedule at fusion-bucket granularity, the analytic
    model of ``comm.overlap``'s executable schedule.

    ``comm_times[b]``   seconds of communication of bucket ``b`` (tree
                        order).
    ``triggers[b]``     the forward-order layer whose weight-gradient pass
                        completes bucket ``b`` (``overlap.bucket_triggers``).
    ``layer_comps[t]``  FLOPs of layer ``t`` per node per iteration (all
                        three passes).

    In issue order, bucket ``b``'s bubble is its own transfer plus all
    issued after it, less the backprop left below its trigger and the
    trigger layer's own input-gradient pass:

        bubble_b = (comm_b + comms issued after b) / comms_sys
                 - (sum_{j < trigger_b} comp_j + comp_{trigger_b}/3) / comp_sys

    Returned in bucket (tree) order, seconds, negative when fully hidden.
    With one bucket per layer this is :func:`bubble_schedule`.
    """
    comp_sys = hw.peak_flops * efficiency
    order = issue_order(triggers)
    total_comm = float(sum(comm_times))
    bubbles = [0.0] * len(comm_times)
    issued = 0.0
    for b in order:
        t = triggers[b]
        ocomp = sum(layer_comps[:t]) + layer_comps[t] / 3.0
        bubbles[b] = (total_comm - issued) - ocomp / comp_sys
        issued += comm_times[b]
    return bubbles


def overlap_exposed_time(comm_times: Sequence[float],
                         triggers: Sequence[int],
                         layer_comps: Sequence[float],
                         hw: HardwareConfig,
                         efficiency: float = 1.0) -> float:
    """Exposed communication (seconds) of the §3.1 overlap schedule, by
    timeline: buckets transfer on one shared link in issue order, each
    issued when its trigger layer's weight gradient finishes and due when
    that layer's next forward starts.  The step stalls by the worst
    lateness over buckets (a stall shifts every later deadline), so the
    result is at most ``sum(comm_times)``, which it equals when no compute
    can overlap."""
    comp_sys = hw.peak_flops * efficiency
    order = issue_order(triggers)
    t_bp = 2.0 / 3.0 * sum(layer_comps) / comp_sys
    below = [0.0]                     # prefix sums: sum_{j<t} comp_j
    for c in layer_comps:
        below.append(below[-1] + c)
    link_free = 0.0
    exposed = 0.0
    for b in order:
        t = triggers[b]
        issue = (2.0 / 3.0 * (below[len(layer_comps)] - below[t + 1])
                 + layer_comps[t] / 3.0) / comp_sys
        finish = max(issue, link_free) + comm_times[b]
        link_free = finish
        deadline = t_bp + below[t] / 3.0 / comp_sys
        exposed = max(exposed, finish - deadline)
    return max(0.0, exposed)


def scaling_efficiency(layers: Sequence[LayerBalance], hw: HardwareConfig,
                       efficiency: float = 1.0) -> float:
    """Paper §3.1: efficiency = (sum comp_i / comp_sys) /
    (sum_i bubble_i+ + sum comp_i / comp_sys); positive bubbles are the
    communication left exposed."""
    comp_sys = hw.peak_flops * efficiency
    t_comp = sum(lyr.comp for lyr in layers) / comp_sys
    bubbles = bubble_schedule(layers, hw, efficiency)
    t_bubble = sum(max(0.0, b) for b in bubbles)
    return t_comp / (t_comp + t_bubble)


def max_data_parallel_nodes(layers: Sequence[LayerBalance],
                            hw: HardwareConfig, minibatch: int) -> float:
    """Paper §3.1: N <= minibatch * (comms_sys/comp_sys) * (ocomp_k/ocomms_k)
    where L_k is the last layer in the data-parallel regime.  comp here is
    per data point (MB_node = 1)."""
    k = len(layers) - 1
    ocomp_k = sum(lyr.comp for lyr in layers[:k]) + layers[k].comp / 3.0
    ocomms_k = sum(lyr.comm for lyr in layers)
    n = minibatch * (hw.link_bw / hw.peak_flops) * (ocomp_k / ocomms_k)
    return min(float(minibatch), n)  # >= 1 data point per node


# ---------------------------------------------------------------------------
# §3.2 model parallelism
# ---------------------------------------------------------------------------
def model_parallel_comm_bytes(ifm: int, in_hw: int, minibatch: int,
                              size_data: int = SIZE_F32) -> float:
    """Paper §3.2 total forward-pass activation exchange:
    size_data * ifm * input_w * input_h * minibatch."""
    return size_data * ifm * in_hw * in_hw * minibatch


def model_parallel_preferred(lyr: ConvLayerSpec, in_hw: int, minibatch: int,
                             overlap: float = 1.0) -> bool:
    """Paper §3.2 decision rule:
    ofm*k_w*k_h*(2-overlap) > input_w*input_h*minibatch  => model parallel.
    For FC layers (k=in=1): ofm > minibatch => model parallel."""
    k = max(lyr.kernel, 1)
    return lyr.ofm * k * k * (2.0 - overlap) > in_hw * in_hw * minibatch


# ---------------------------------------------------------------------------
# §3.3 hybrid parallelism
# ---------------------------------------------------------------------------
def hybrid_comm_bytes(ifm: int, ofm: int, kernel: int, in_hw: int,
                      minibatch: int, G: int, N: int,
                      overlap: float = 0.0, size_data: int = SIZE_F32) -> float:
    """Paper §3.3: total communication volume for G data-parallel groups of
    N/G model-parallel nodes:
        G > 1: 2*size*ifm*in_w*in_h*(minibatch/G)
               + size*ofm*ifm*k_w*k_h*(2-overlap)*(G/N)
        G = 1: 2*size*ifm*in_w*in_h*minibatch            (pure model parallel)
    """
    k = max(kernel, 1)
    if G <= 1:
        return 2.0 * size_data * ifm * in_hw * in_hw * minibatch
    model_part = 2.0 * size_data * ifm * in_hw * in_hw * (minibatch / G)
    data_part = size_data * ofm * ifm * k * k * (2.0 - overlap) * (G / N)
    return model_part + data_part


def optimal_group_count(N: int, minibatch: int, ofm: int) -> int:
    """Paper §3.3 (FC layer, FP32, no overlap):
    d(8*ifm*(minibatch/G + ofm*G/N))/dG = 0  =>  G = sqrt(N*minibatch/ofm).
    Clamped to [1, N] and rounded to the nearest divisor-friendly integer."""
    g = math.sqrt(N * minibatch / ofm)
    g = max(1.0, min(float(N), g))
    return max(1, round(g))


def hybrid_comm_at_optimum(ifm: int, ofm: int, minibatch: int, N: int,
                           size_data: int = SIZE_F32) -> Tuple[int, float]:
    """Evaluate the §3.3 FC example.  For ofm=4096, minibatch=256, N=64 the
    paper gets G=3 and volume 8*ifm*213 (vs 8*ifm*256 for G=1)."""
    G = optimal_group_count(N, minibatch, ofm)
    vol = hybrid_comm_bytes(ifm, ofm, 1, 1, minibatch, G, N, overlap=0.0,
                            size_data=size_data)
    return G, vol


# ---------------------------------------------------------------------------
# §3.2 latency + bucket term (extends the paper's pure-bandwidth comm model)
# ---------------------------------------------------------------------------
# The paper's comms_sys is bandwidth-only; its SWlat appears once per message.
# The part-reduce/part-broadcast pair for one fusion buffer on a ring of G
# members costs 2*(G-1) messages, so issuing one pair PER TENSOR puts nets
# with many small tensors (VGG-A conv biases) in the latency-bound regime.
# Bucketing (``comm.bucketer``) amortizes SWlat over bucket_bytes; these
# closed forms predict the collective count and the optimal bucket size.


@dataclass(frozen=True)
class RingBackendModel:
    """How a collective backend (``comm.backends``) shifts the §3.2 comm
    constants: per-message software latency scales by ``latency_scale`` and
    the achieved link bandwidth is ``bw_efficiency * hw.link_bw``."""
    latency_scale: float
    bw_efficiency: float


# Per-backend constants for the ring cost model, the reference's numbers,
# kept for parity: they are the reference's provisional model of its own
# TPU rings ("lax" the calibration baseline, "pallas-ring" half the
# per-message latency at 95% of the link, "gossip" stock message constants
# whose win is the message count, see gossip_exchange_time), not a property
# of the H100 or of the port's rings.  The port's measured constants come
# from ``comm="auto"`` (``telemetry.autotune``), which fits SWlat and BW on
# the live mesh and bypasses this table.
RING_BACKEND_MODELS = {
    "lax": RingBackendModel(latency_scale=1.0, bw_efficiency=1.0),
    "pallas-ring": RingBackendModel(latency_scale=0.5, bw_efficiency=0.95),
    "gossip": RingBackendModel(latency_scale=1.0, bw_efficiency=1.0),
}


# Cross-HOST link regimes for the cluster subsystem (``cluster``): when
# the "pod" axis is a process/host boundary (launch.mesh.make_cluster_mesh),
# the hierarchical schedule's cross-pod hop crosses one of these links, not
# the in-node fabric.  (link bytes/s per direction, per-message SWlat s) —
# the paper's §5 hardware: FDR InfiniBand on the Endeavor cluster (RDMA, the
# §3.2 calibration SWlat) and 10GbE Ethernet on the 16-node AWS cluster
# (~14X on 16 — kernel TCP stack, ~10x the per-message software latency).
CROSS_HOST_REGIMES = {
    "infiniband-fdr": (56e9 / 8, 5e-6),
    "ethernet-10gbe": (10e9 / 8, 50e-6),
}


def cross_host_hw(hw: HardwareConfig, regime: str) -> HardwareConfig:
    """``hw`` with its link constants replaced by a cross-host regime's —
    feed the result to ``hierarchical_allreduce_time`` (with ``pod_bw`` set
    to the fast in-host bandwidth) to model a multi-host cluster step."""
    if regime not in CROSS_HOST_REGIMES:
        raise ValueError(f"unknown cross-host regime {regime!r}; "
                         f"known: {tuple(CROSS_HOST_REGIMES)}")
    bw, lat = CROSS_HOST_REGIMES[regime]
    return dataclasses.replace(hw, name=f"{hw.name}+{regime}",
                               link_bw=bw, sw_latency=lat)


def backend_hw(hw: HardwareConfig, backend: str) -> HardwareConfig:
    """``hw`` with the backend's latency/bandwidth constants applied —
    the one place backend names enter the §3.2 closed forms."""
    if backend not in RING_BACKEND_MODELS:
        raise ValueError(f"unknown collective backend {backend!r}; "
                         f"known: {tuple(RING_BACKEND_MODELS)}")
    m = RING_BACKEND_MODELS[backend]
    if m.latency_scale == 1.0 and m.bw_efficiency == 1.0:
        return hw
    return dataclasses.replace(
        hw, name=f"{hw.name}+{backend}",
        sw_latency=hw.sw_latency * m.latency_scale,
        link_bw=hw.link_bw * m.bw_efficiency)


def collective_count(total_bytes: float, n_tensors: int,
                     bucket_bytes: float) -> int:
    """Part-reduce/part-broadcast pairs per step: O(#tensors) without
    fusion (bucket_bytes <= 0), O(total_bytes / bucket_bytes) with it."""
    if bucket_bytes <= 0:
        return n_tensors
    return max(1, math.ceil(total_bytes / bucket_bytes))


def ring_collective_time(nbytes: float, G: int, hw: HardwareConfig,
                         backend: str = "lax") -> float:
    """One reduce-scatter + all-gather pair on a G-member ring:
    2*(G-1) messages of nbytes/G each (bandwidth-optimal decomposition,
    see collectives.part_reduce_broadcast) + per-message SWlat.  ``backend``
    applies the per-implementation constants (``RING_BACKEND_MODELS``)."""
    if G <= 1:
        return 0.0
    hw = backend_hw(hw, backend)
    return 2.0 * (G - 1) * (hw.sw_latency + (nbytes / G) / hw.link_bw)


def bucketed_allreduce_time(total_bytes: float, n_tensors: int,
                            bucket_bytes: float, G: int,
                            hw: HardwareConfig,
                            n_coll: int = 0,
                            fill_bytes: float = 0.0,
                            backend: str = "lax") -> float:
    """Gradient round-trip time with fusion buffers:
        n_coll * 2*(G-1)*SWlat            (latency, amortized by bucketing)
      + 2*(G-1)/G * total_bytes / BW      (bandwidth, bucket-independent)
      + 2*(G-1)/G * fill_bytes / BW       (pipeline fill: the first message
                                           cannot overlap anything)
    Minimized by ``optimal_bucket_bytes``.  The fill term applies to EVERY
    schedule — per-tensor included: its granularity is the largest single
    tensor, which for fc-heavy nets dwarfs any sane bucket.

    ``n_coll`` overrides the closed-form collective count with the REAL
    planner's (``comm.bucketer.plan_buckets(...).n_collectives``) — the closed
    form assumes tensors split freely across buckets, but the planner never
    splits one, so a tree dominated by a few huge tensors issues far fewer
    collectives than ceil(total/bucket).  ``fill_bytes`` likewise overrides
    the default average-message estimate (total/n_coll) with the largest
    real message when the caller knows it.  ``backend`` applies the
    per-implementation ring constants (``RING_BACKEND_MODELS``)."""
    if G <= 1:
        return 0.0
    hw = backend_hw(hw, backend)
    if n_coll <= 0:
        n_coll = collective_count(total_bytes, n_tensors, bucket_bytes)
    if fill_bytes <= 0:
        fill_bytes = total_bytes / n_coll
    frac = 2.0 * (G - 1) / G
    return (n_coll * 2.0 * (G - 1) * hw.sw_latency
            + frac * (total_bytes + fill_bytes) / hw.link_bw)


# ---------------------------------------------------------------------------
# Compressed wire formats (CommConfig.wire_format): bytes-on-wire models.
# The reduce side of the §3.4 strip roundtrip can ship a compressed encoding
# (the ring dequantizes/accumulates/re-encodes per hop — kernels/ring.py);
# the all-gather side broadcasts WEIGHTS and always stays dense fp32.  These
# constants are what the comm sweep and the comm="auto" autotuner use to
# pick wire format + bucket size jointly.
# ---------------------------------------------------------------------------
WIRE_FORMAT_BYTES = {"fp32": 4.0, "bf16": 2.0, "int8": 1.0}
INT8_SCALE_BYTES = 4     # one f32 max-abs scale rides along per int8 message
TOPK_ENTRY_BYTES = 8.0   # 4B f32 value + 4B int32 index per kept element


def wire_bytes_per_element(wire_format: str, topk_ratio: float = 0.05) -> float:
    """Reduce-side wire bytes per (dense fp32) gradient element."""
    if wire_format == "topk":
        return TOPK_ENTRY_BYTES * topk_ratio
    try:
        return WIRE_FORMAT_BYTES[wire_format]
    except KeyError:
        raise ValueError(
            f"unknown wire format {wire_format!r}; known: "
            f"{tuple(WIRE_FORMAT_BYTES) + ('topk',)}") from None


def wire_reduce_factor(wire_format: str, topk_ratio: float = 0.05) -> float:
    """Reduce-side bytes-on-wire as a fraction of dense fp32 (fp32 -> 1,
    bf16 -> 0.5, int8 -> 0.25, topk -> 2*ratio)."""
    return wire_bytes_per_element(wire_format, topk_ratio) / SIZE_F32


def wire_reduce_bytes(total_bytes: float, G: int, n_coll: int,
                      wire_format: str, topk_ratio: float = 0.05) -> float:
    """Total reduce-side wire bytes of one step: the compressed payload plus
    the int8 per-message scale overhead ((G-1) messages per collective).
    ``total_bytes`` is the DENSE fp32 gradient volume."""
    data = total_bytes * wire_reduce_factor(wire_format, topk_ratio)
    if wire_format == "int8":
        data += n_coll * max(G - 1, 0) * INT8_SCALE_BYTES
    return data


def compressed_allreduce_time(total_bytes: float, n_tensors: int,
                              bucket_bytes: float, G: int,
                              hw: HardwareConfig,
                              wire_format: str = "fp32",
                              topk_ratio: float = 0.05,
                              n_coll: int = 0,
                              fill_bytes: float = 0.0,
                              backend: str = "lax") -> float:
    """``bucketed_allreduce_time`` with a compressed reduce wire: the
    reduce-scatter side moves ``wire_reduce_factor`` of the dense bytes,
    the all-gather (weight broadcast) side stays dense fp32:

        n_coll * 2*(G-1)*SWlat
      + (G-1)/G * (1 + f) * (total_bytes + fill_bytes) / BW

    At ``f = 1`` (fp32) this IS ``bucketed_allreduce_time``."""
    if G <= 1:
        return 0.0
    hw = backend_hw(hw, backend)
    if n_coll <= 0:
        n_coll = collective_count(total_bytes, n_tensors, bucket_bytes)
    if fill_bytes <= 0:
        fill_bytes = total_bytes / n_coll
    f = wire_reduce_factor(wire_format, topk_ratio)
    return (n_coll * 2.0 * (G - 1) * hw.sw_latency
            + (G - 1) / G * (1.0 + f)
            * (total_bytes + fill_bytes) / hw.link_bw)


def optimal_bucket_bytes(total_bytes: float, G: int,
                         hw: HardwareConfig,
                         wire_format: str = "fp32",
                         topk_ratio: float = 0.05) -> float:
    """Minimizer of ``compressed_allreduce_time`` over the bucket size:
    d/db [ (B/b)*2*(G-1)*SWlat + (G-1)/G * (1+f) * (B+b)/BW ] = 0
        =>  b* = sqrt(B * SWlat * BW * G * 2/(1+f))
    where ``f`` is the reduce-side ``wire_reduce_factor`` — at fp32
    (f = 1) this is the classic ``b* = sqrt(B * SWlat * BW * G)``.  A
    compressed wire shrinks the bandwidth term, so the latency term is
    amortized over a LARGER optimal bucket.  Clamped to [64 KiB, B] (a
    bucket never exceeds the whole tree)."""
    if G <= 1 or total_bytes <= 0:
        return total_bytes
    f = wire_reduce_factor(wire_format, topk_ratio)
    b = math.sqrt(total_bytes * hw.sw_latency * hw.link_bw * G
                  * 2.0 / (1.0 + f))
    return max(min(b, total_bytes), min(64 * 1024, total_bytes))


def hierarchical_allreduce_time(total_bytes: float, n_tensors: int,
                                bucket_bytes: float, g_in: int, g_out: int,
                                hw: HardwareConfig,
                                pod_bw: float = 0.0,
                                n_coll: int = 0,
                                fill_bytes: float = 0.0,
                                backend: str = "lax",
                                cross_backend: str = "lax") -> float:
    """Two-level schedule (``comm.schedule.HierarchicalSchedule``): bucketed
    reduce-scatter + all-gather in-pod over ``g_in`` members at the fast
    in-pod bandwidth ``pod_bw`` (defaults to hw.link_bw), plus the cross-pod
    hop over ``g_out`` pods moving only the 1/g_in strip bytes on
    hw.link_bw.  Composes the paper's §3.3 node groups.

    Both stages issue ONE collective per bucket (the cross-pod hop reduces
    each bucket's strip, it does not re-bucket it), so a single collective
    count applies to both; ``n_coll`` overrides it with the real planner's.
    ``backend`` applies to the in-pod stage and ``cross_backend`` to the
    cross-pod hop — mirroring ``make_schedule``'s per-level backends."""
    if n_coll <= 0:
        n_coll = collective_count(total_bytes, n_tensors, bucket_bytes)
    pod_hw = hw if pod_bw <= 0 else dataclasses.replace(
        hw, name=hw.name + "+pod", link_bw=pod_bw)
    t_in = bucketed_allreduce_time(total_bytes, n_tensors, bucket_bytes,
                                   g_in, pod_hw, n_coll=n_coll,
                                   fill_bytes=fill_bytes, backend=backend)
    strip_bytes = total_bytes / max(g_in, 1)
    t_out = bucketed_allreduce_time(strip_bytes, n_tensors, bucket_bytes,
                                    g_out, hw, n_coll=n_coll,
                                    fill_bytes=fill_bytes / max(g_in, 1),
                                    backend=cross_backend)
    return t_in + t_out


# ---------------------------------------------------------------------------
# Relaxed-consistency modes (PARALLEL_MODES stale-sync / gossip): what each
# buys per step relative to the synchronous §3.2 ring round-trip above
# ---------------------------------------------------------------------------
def gossip_exchange_time(total_bytes: float, n_tensors: int,
                         bucket_bytes: float, G: int,
                         hw: HardwareConfig,
                         n_coll: int = 0,
                         backend: str = "gossip") -> float:
    """Per-step wire time of the GossipGraD partner exchange
    (``comm.backends.gossip``) plus the unchanged strip all-gather:

        n_coll * SWlat + (total/G) / BW              (exchange: ONE
                                                      chunk-sized partner
                                                      message per bucket)
      + n_coll * (G-1) * SWlat
      + (G-1)/G * total / BW                         (all-gather: params
                                                      must stay replicated)

    versus the synchronous ring's ``2*(G-1)`` messages per bucket
    (``bucketed_allreduce_time``) — the reduce side drops from G-1
    messages to one, which is the latency-bound-regime win the mode
    exists for.  Same knob conventions as the ring forms (``n_coll``
    overrides the closed-form collective count with the real planner's).
    """
    if G <= 1:
        return 0.0
    hw = backend_hw(hw, backend)
    if n_coll <= 0:
        n_coll = collective_count(total_bytes, n_tensors, bucket_bytes)
    exchange = n_coll * hw.sw_latency + (total_bytes / G) / hw.link_bw
    gather = (n_coll * (G - 1) * hw.sw_latency
              + ((G - 1) / G) * total_bytes / hw.link_bw)
    return exchange + gather


def stale_sync_exposed_time(comm_time: float, compute_time: float) -> float:
    """Exposed comm under bounded staleness (PARALLEL_MODES "stale-sync"):
    step t consumes the reduce issued at t-1, so a FULL step of compute is
    available to hide it — exposure is only the overflow.  The limit of the
    §3.1 bubble schedule when the overlap window grows from the remaining
    backprop to the whole step; the price is a one-step-old gradient, not
    wire time."""
    return max(0.0, comm_time - compute_time)


# ---------------------------------------------------------------------------
# Whole-network scaling model (drives the Fig 4 / Fig 6 / Fig 7 benchmarks)
# ---------------------------------------------------------------------------
def network_balance(conv_layers: Sequence[ConvLayerSpec],
                    fc_layers: Sequence[ConvLayerSpec],
                    minibatch: int, nodes: int, hw: HardwareConfig,
                    compute_eff: float = 0.75,
                    overlap: float = 1.0) -> dict:
    """Estimate one-iteration time and scaling efficiency at ``nodes`` nodes.

    Conv layers run data-parallel with the §3.1 bubble/overlap model.
    FC layers run hybrid-parallel with the §3.3 optimal G; their activation
    and weight exchanges are not overlappable with conv compute in the
    paper's schedule, so their comm adds serially (conservative, matches the
    paper's observation that FC layers 'do not scale much').
    """
    mb_node = max(1.0, minibatch / nodes)
    comp_sys = hw.peak_flops * compute_eff

    conv = [LayerBalance(f"conv{i}", conv_comp_flops(lyr, mb_node),
                         data_parallel_comm_bytes(lyr, overlap))
            for i, lyr in enumerate(conv_layers)]
    t_conv_comp = sum(lyr.comp for lyr in conv) / comp_sys
    if nodes == 1:
        t_conv = t_conv_comp
        t_fc = sum(fc_comp_flops(lyr.ifm, lyr.ofm, minibatch) for lyr in fc_layers) / comp_sys
        return dict(step_time=t_conv + t_fc, efficiency=1.0, G_fc=1)

    bubbles = bubble_schedule(conv, hw, compute_eff)
    t_conv = t_conv_comp + sum(max(0.0, b) for b in bubbles)

    t_fc = 0.0
    G_used = 1
    for lyr in fc_layers:
        G = optimal_group_count(nodes, minibatch, lyr.ofm)
        G_used = G
        comm = hybrid_comm_bytes(lyr.ifm, lyr.ofm, 1, 1, minibatch, G, nodes,
                                 overlap=0.0)
        comp = fc_comp_flops(lyr.ifm, lyr.ofm, minibatch) / nodes
        t_fc += comp / comp_sys + comm / hw.link_bw + hw.sw_latency
    step = t_conv + t_fc
    # efficiency vs perfect scaling of the single-node time
    single = (sum(conv_comp_flops(lyr, minibatch) for lyr in conv_layers)
              + sum(fc_comp_flops(lyr.ifm, lyr.ofm, minibatch) for lyr in fc_layers)) / comp_sys
    eff = single / (nodes * step)
    return dict(step_time=step, efficiency=min(1.0, eff), G_fc=G_used)


def dnn_hybrid_scaling(input_dim: int, hidden: int, n_hidden: int,
                       output_dim: int, minibatch: int, nodes: int,
                       hw: HardwareConfig, compute_eff: float = 0.6) -> dict:
    """§5.4 CD-DNN: all-FC network under hybrid parallelism."""
    dims = [(input_dim, hidden)] + [(hidden, hidden)] * (n_hidden - 1) \
        + [(hidden, output_dim)]
    comp_sys = hw.peak_flops * compute_eff
    if nodes == 1:
        t = sum(fc_comp_flops(i, o, minibatch) for i, o in dims) / comp_sys
        return dict(step_time=t, efficiency=1.0, speedup=1.0)
    t = 0.0
    for i, o in dims:
        G = optimal_group_count(nodes, minibatch, o)
        comm = hybrid_comm_bytes(i, o, 1, 1, minibatch, G, nodes, overlap=0.5)
        t += fc_comp_flops(i, o, minibatch) / nodes / comp_sys \
            + comm / hw.link_bw + hw.sw_latency
    single = sum(fc_comp_flops(i, o, minibatch) for i, o in dims) / comp_sys
    return dict(step_time=t, efficiency=min(1.0, single / (nodes * t)),
                speedup=single / t)
