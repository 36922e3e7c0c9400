"""``repro_torch.launch.profile.device_activity`` on the CPU, on made-up
profiler events: the device's busy time is the union of its own activity
intervals, so a PyTorch operator (a host event) is never added to the
kernels it launched, and overlapping kernels are not counted twice."""
from types import SimpleNamespace

import pytest
import torch

from repro_torch.launch.profile import device_activity

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("events, busy_ms", [
    ([], 0.0),
    ([_ev("k", 0, 1000), _ev("k", 2000, 2500)], 1.5),            # disjoint
    ([_ev("a", 0, 1000), _ev("b", 500, 1500)], 1.5),             # overlap
    ([_ev("a", 0, 3000), _ev("b", 1000, 2000)], 3.0),            # nested
    ([_ev("aten::copy_", 0, 5000, CPU), _ev("copy", 1000, 2000)], 1.0),
])
def test_device_busy_is_the_union_of_device_intervals(events, busy_ms):
    busy, _ = device_activity(events)
    assert busy == pytest.approx(busy_ms)


def test_device_activity_ranks_device_names_only():
    events = [_ev("aten::mm", 0, 9000, CPU), _ev("gemm", 0, 2000),
              _ev("copy", 2000, 2500), _ev("gemm", 3000, 4000)]
    busy, ranked = device_activity(events)
    assert busy == pytest.approx(3.5)
    assert ranked == [("gemm", 2, pytest.approx(3.0)),
                      ("copy", 1, pytest.approx(0.5))]
