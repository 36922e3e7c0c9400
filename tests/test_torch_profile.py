"""``repro_torch.launch.profile.device_activity`` on the CPU, on made-up
profiler events: the device's busy time is the union of its own activity
intervals, so a PyTorch operator (a host event) is never added to the
kernels it launched, and overlapping kernels are not counted twice."""
from types import SimpleNamespace

import pytest
import torch

from repro_torch.launch.profile import (device_activity, host_launches,
                                        labelled_appends)

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, device=CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("events, busy_ms", [
    ([], 0.0),
    ([_ev("k", 0, 1000), _ev("k", 2000, 2500)], 1.5),            # disjoint
    ([_ev("a", 0, 1000), _ev("b", 500, 1500)], 1.5),             # overlap
    ([_ev("a", 0, 3000), _ev("b", 1000, 2000)], 3.0),            # nested
    ([_ev("aten::copy_", 0, 5000, CPU), _ev("copy", 1000, 2000)], 1.0),
    # a record_function range's device twin spans its kernels: not counted
    ([_ev("kv_append", 0, 9000, annotation=True), _ev("k", 1000, 2000)], 1.0),
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


def test_host_launches_counts_launch_calls_inside_the_ranges():
    events = [_ev("cudaLaunchKernel", 10, 12, CPU),
              _ev("cudaLaunchKernel", 30, 31, CPU),
              _ev("cudaMemsetAsync", 55, 56, CPU),
              _ev("aten::add", 30, 40, CPU),                 # no launch call
              _ev("cudaLaunchKernel", 30, 31)]               # a device event
    assert host_launches(events) == (3, 0)
    assert host_launches(events, [(25, 60)]) == (3, 2)
    assert host_launches(events, [(0, 11), (50, 60)]) == (3, 2)


def test_labelled_appends_wraps_and_restores_every_append():
    from repro_torch.core import kvcache
    from repro_torch.models import transformer

    before = (kvcache.append_kv, kvcache.append_token,
              kvcache.append_token_paged, transformer._append_kv)
    with labelled_appends():
        wrapped = (kvcache.append_kv, kvcache.append_token,
                   kvcache.append_token_paged, transformer._append_kv)
        assert all(w is not b for w, b in zip(wrapped, before))
        cache = torch.zeros(2, 4, 1, 2, dtype=torch.bfloat16)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            transformer._append_kv(cache, torch.ones(2, 1, 1, 2),
                                   torch.tensor([0, 3]))
    assert (kvcache.append_kv, kvcache.append_token,
            kvcache.append_token_paged, transformer._append_kv) == before
    assert [e.name for e in prof.events()].count("kv_append") == 1
    assert cache[0, 0].float().sum() == 2 and cache[1, 3].float().sum() == 2


@pytest.mark.parametrize("kv_format", ["hif4", "bf16"])
def test_kv_format_flag_profiles_either_cache(kv_format, monkeypatch, capsys):
    """The launcher's flow at the reduced config on the CPU (a rehearsal:
    no device time exists here): the flag picks the cache and the KV
    appends are counted: 2 layers x one call for K and V (HiF4), or one
    each (bf16)."""
    import repro_torch.launch.profile as P
    from repro_torch.configs import get_arch

    monkeypatch.setattr(P, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(P, "get_arch", lambda a: get_arch(a).reduced())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    assert P.main(["--batch", "2", "--prompt-len", "8", "--steps", "1",
                   "--kv-format", kv_format, "--top", "1"]) == 0
    out = capsys.readouterr().out
    assert f"contiguous {kv_format} KV cache" in out
    calls = {"hif4": 2, "bf16": 4}[kv_format]
    assert f"KV append: {calls} calls/step" in out


def test_kv_format_flag_refuses_a_bf16_pool():
    import repro_torch.launch.profile as P

    with pytest.raises(SystemExit):
        P.main(["--kv-pages", "65", "--kv-format", "bf16"])
    with pytest.raises(SystemExit):
        P.main(["--kv-format", "fp8"])
