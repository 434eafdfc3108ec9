"""The reduction of a trace by the program's spans (``bench/spans.py``) on
a synthetic timeline, microseconds on one clock."""
from __future__ import annotations

import pytest

from bench import spans


class _Ev:
    def __init__(self, name, a, b, cuda=False, id=None, thread=1,
                 annotation=False):
        import torch
        self.name, self.id, self.thread = name, id, thread
        self.is_user_annotation = annotation
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"start": a, "end": b})


def _timeline():
    r = lambda kind, a, b: _Ev("repro_torch." + kind, a, b)  # noqa: E731
    return [
        r("step", 0, 1000), r("forward", 10, 200), r("backward", 200, 600),
        r("clip", 600, 650), r("update", 650, 900), r("reduce", 660, 700),
        # the device's copy of a host range is no operation
        _Ev("repro_torch.forward", 100, 300, cuda=True, annotation=True),
        _Ev("aten::mm", 15, 40),
        _Ev("cudaLaunchKernel", 20, 25, id=1),
        _Ev("sgemm", 100, 300, cuda=True, id=1),
        # autograd's device thread, inside the backward range's interval
        # but no child of it
        _Ev("autograd::engine::evaluate_function: MmBackward0", 240, 280,
            thread=2),
        _Ev("cudaLaunchKernel", 250, 255, id=2, thread=2),
        _Ev("sgemm", 300, 700, cuda=True, id=2),
        _Ev("cudaMemcpyAsync", 620, 622, id=3),
        _Ev("Memcpy DtoD", 700, 710, cuda=True, id=3),
        _Ev("cudaStreamSynchronize", 640, 648),
        _Ev("cudaLaunchKernel", 670, 672, id=4),
        _Ev("fold_kernel", 710, 760, cuda=True, id=4),
        # a blocking copy: a launch and a sync, in the update
        _Ev("cudaMemcpy", 800, 830, id=7),
        _Ev("Memcpy DtoH", 805, 828, cuda=True, id=7),
        # outside every range: a launch, a sync; a device op never launched
        # in the trace
        _Ev("cudaDeviceSynchronize", 1050, 1090),
        _Ev("cudaLaunchKernel", 1100, 1104, id=5),
        _Ev("elementwise_kernel", 1100, 1150, cuda=True, id=5),
        _Ev("elementwise_kernel", 1200, 1210, cuda=True, id=6),
    ]


def test_device_time_goes_to_the_innermost_range_at_launch():
    s = spans.summarize(_timeline(), 2)
    assert s.count == {"step": 1, "forward": 1, "backward": 1, "clip": 1,
                       "update": 1, "reduce": 1}
    assert s.device_s == pytest.approx({"forward": 200e-6,
                                        "backward": 400e-6, "clip": 10e-6,
                                        "reduce": 50e-6, "update": 23e-6})
    assert s.outside_s == pytest.approx(50e-6)
    assert s.unmatched_s == pytest.approx(10e-6)
    assert s.total_s == pytest.approx(743e-6)
    assert s.step_launches == 5
    assert s.sync_s == pytest.approx({"clip": 8e-6, "update": 30e-6})
    # a step's ms: two steps in the stretch
    assert s.ms_per_step("backward") == pytest.approx(0.2)
    assert s.ms_per_step(*spans.UPDATE) == pytest.approx(0.0365)
    assert s.ms_per_step("apply") == 0.0
    assert s.launches_per_step() == 2.5
    assert s.sync_ms_per_step() == pytest.approx(0.019)


def test_a_trace_without_ranges_or_device_ops_reads_nothing():
    bare = [e for e in _timeline() if not e.name.startswith("repro_torch.")]
    for s in (spans.summarize(bare, 2),
              spans.summarize([e for e in _timeline()
                               if e.device_type.name == "CPU"], 2)):
        assert s.ms_per_step("forward") is None
        assert s.launches_per_step() is None
        assert s.sync_ms_per_step() is None
    assert spans.summarize(bare, 2).outside_s == pytest.approx(743e-6 - 10e-6)
