"""``repro_torch.launch.profile.device_activity`` on the CPU, on made-up
profiler events: the device's busy time is the union of its own activity
intervals, so a PyTorch operator (a host event) is never added to the
kernels it launched, and overlapping kernels are not counted twice."""
from types import SimpleNamespace

import pytest
import torch

from repro_torch.launch.profile import (device_activity, host_launches,
                                        span_table)

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, device=CUDA, annotation=False, corr=0):
    return SimpleNamespace(name=name, device_type=device, id=corr,
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


def test_span_table_counts_each_launch_to_its_innermost_span():
    events = [_ev("lm.decode_step", 0, 100, CPU),
              _ev("linear", 10, 20, CPU),
              _ev("cudaLaunchKernel", 12, 13, CPU, corr=1),
              _ev("cudaLaunchKernel", 30, 31, CPU, corr=2),
              _ev("cudaLaunchKernel", 150, 151, CPU, corr=3),
              _ev("gemm", 40, 60, corr=1),              # runs after its span
              _ev("add", 60, 65, corr=2),
              _ev("copy", 160, 161, corr=3),
              _ev("linear", 0, 200, annotation=True)]   # a device twin
    assert span_table(events) == {"lm.decode_step": [1, 100, 5, 1],
                                  "linear": [1, 10, 20, 1],
                                  "(none)": [0, 0.0, 1, 1]}


def _reduced_decode(kv_format):
    """A packed serve of the reduced qwen config, prefilled: (step, cache)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import kvcache
    from repro_torch.core.policy import get_policy
    from repro_torch.models import lm
    from repro_torch.models.common import ModelCtx
    from repro_torch.runtime.serve_loop import (
        ServeConfig, build_decode_cache, prepare_params_for_serving, serving_ctx)

    cfg = get_arch("qwen1.5-0.5b").reduced()
    plan = lm.quant_plan(cfg, get_policy("paper-iv", impl="packed",
                                         kv=kvcache.KVCacheConfig(kv_format)))
    sctx = serving_ctx(ModelCtx(plan=plan))
    cpu = torch.device("cpu")
    params = prepare_params_for_serving(lm.init_params(cfg, 0, device=cpu),
                                        cfg, plan, device=cpu)
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = build_decode_cache(cfg, params, {"tokens": tokens}, sctx,
                                       ServeConfig(max_new_tokens=4))
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    return cfg, (lambda c: lm.decode_step(params, token, c, cfg, sctx)), cache


@pytest.mark.parametrize("kv_format", ["hif4", "bf16"])
def test_decode_step_spans_each_kv_append_only_under_the_profiler(
        kv_format, monkeypatch):
    """One ``kv.append`` range per append call (the HiF4 cache's one a
    layer; the bf16 cache's K and V) under the CPU profiler, and no range
    entered without it."""
    from repro_torch.core import kvcache
    from repro_torch.models import transformer

    cfg, step, cache = _reduced_decode(kv_format)
    module, name = ((kvcache, "append_kv") if kv_format == "hif4"
                    else (transformer, "_append_kv"))
    append, calls = getattr(module, name), []

    def counted(*a, **kw):
        calls.append(1)
        return append(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    with monkeypatch.context() as m:
        def entered(*a, **kw):
            raise AssertionError("a span entered record_function")
        m.setattr(torch.profiler, "record_function", entered)
        _, cache = step(cache)
    per_step = len(calls)
    assert per_step == cfg.n_layers * (1 if kv_format == "hif4" else 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(cache)
    assert len(calls) == 2 * per_step
    names = [e.name for e in prof.events()]
    assert names.count("kv.append") == per_step
    assert names.count("lm.decode_step") == 1


@pytest.mark.parametrize("kv_format", ["hif4", "bf16"])
def test_kv_format_flag_profiles_either_cache(kv_format, monkeypatch, capsys):
    """The launcher's flow at the reduced config on the CPU (a rehearsal:
    no device time exists here): the flag picks the cache and the KV
    appends are counted: 2 layers x one call for K and V (HiF4), or one
    each (bf16); the profiled prefill's table names its spans, ``kv.pack``
    for the HiF4 cache alone."""
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
    prefill = out.split("spans of the profiled prefill:\n")[1]
    prefill = {line.split()[0]: int(line.split()[1])
               for line in prefill.split("top device time")[0].splitlines()}
    assert prefill["lm.prefill"] == 1 and prefill["attn.prefill"] == 2
    assert prefill.get("kv.pack") == (1 if kv_format == "hif4" else None)


def test_kv_format_flag_refuses_a_bf16_pool():
    import repro_torch.launch.profile as P

    with pytest.raises(SystemExit):
        P.main(["--kv-pages", "65", "--kv-format", "bf16"])
    with pytest.raises(SystemExit):
        P.main(["--kv-format", "fp8"])
