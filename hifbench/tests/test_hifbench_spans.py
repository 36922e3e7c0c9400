"""The span attribution on the CPU: on made-up events, each device op counts
to the innermost program span that held its launch call, whenever it ran;
on a tiny cell's traced serve, the program records the spans the
attribution reads."""
from types import SimpleNamespace

import pytest
import torch

from hifbench.harness import spans, trace
from hifbench.harness.program import Program
from hifbench.harness.spec import Cell
from hifbench.tests.tiny import write_tree

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, device=CPU, corr=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=corr,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


# a decode phase [0, 100]: a step span holds an ssd.step span (launch 1 at
# 12, its op run at 30-40, after the span's end) and a linear (launch 2 at
# 52, op 60-64); an operator range opened mid-span holds launch 3 (op
# 70-71); launch 4 at 95 lies outside every span (op 96-97). The idle
# gaps 0-30, 40-60, 64-70, 71-96, 97-100 have their midpoints in the
# ssd.step, the linear, the step twice and no span.
EVENTS = [
    _ev(trace.DECODE, 0, 100),
    _ev("lm.decode_step", 5, 90),
    _ev("ssd.step", 10, 20),
    _ev("linear", 50, 55),
    _ev("aten::mul", 18, 80),
    _ev("cudaLaunchKernel", 12, 13, corr=1),
    _ev("cudaLaunchKernel", 52, 53, corr=2),
    _ev("cudaMemsetAsync", 60, 61, corr=3),
    _ev("cudaLaunchKernel", 95, 96, corr=4),
    _ev("cudaDeviceSynchronize", 97, 100, corr=5),
    _ev("elementwise", 30, 40, CUDA, corr=1),
    _ev("gemm", 60, 64, CUDA, corr=2),
    _ev("Memset", 70, 71, CUDA, corr=3),
    _ev("copy", 96, 97, CUDA, corr=4),
    _ev("ssd.step", 10, 20, CUDA, annotation=True),      # a device twin
]


def test_attribution_by_launch_call_and_innermost_span():
    table = spans.attribute(EVENTS)["decode"]
    assert table["ssd.step"] == {"calls": 1, "host_us": 10, "device_us": 10,
                                 "launches": 1, "idle_us": 30}
    assert table["linear"] == {"calls": 1, "host_us": 5, "device_us": 4,
                               "launches": 1, "idle_us": 20}
    # the step's own: launch 3, inside the operator range, which is no span
    assert table["lm.decode_step"] == {"calls": 1, "host_us": 85,
                                       "device_us": 1, "launches": 1,
                                       "idle_us": 6 + 25}
    assert table["(none)"] == {"calls": 0, "host_us": 0.0, "device_us": 1,
                               "launches": 1, "idle_us": 3}


def test_attribution_sums_to_the_phase_that_analyze_reads():
    phase = trace.analyze(EVENTS)["phases"]["decode"]
    table = spans.attribute(EVENTS)["decode"]
    assert sum(r["device_us"] for r in table.values()) == sum(
        phase["kernel_us"].values())
    assert sum(r["launches"] for r in table.values()) == phase["launches"]
    assert sum(r["idle_us"] for r in table.values()) == (
        phase["wall_us"] - phase["busy_us"])


def test_nested_spans_count_once_and_unmatched_ops_go_under_none():
    events = [_ev(trace.PREFILL, 0, 50), _ev("lm.prefill", 1, 49),
              _ev("attn.prefill", 10, 20), _ev("attn.prefill", 30, 40),
              _ev("cudaLaunchKernel", 11, 12, corr=7),
              _ev("cudaLaunchKernel", 31, 32, corr=8),
              _ev("bmm", 12, 22, CUDA, corr=7), _ev("bmm", 32, 38, CUDA, corr=8),
              _ev("lost", 40, 41, CUDA, corr=99)]         # no launch call
    table = spans.attribute(events)["prefill"]
    assert table["attn.prefill"]["calls"] == 2
    assert table["attn.prefill"]["host_us"] == 20
    assert table["attn.prefill"]["device_us"] == 16
    assert table["lm.prefill"]["device_us"] == 0
    assert table["(none)"]["device_us"] == 1
    assert "decode" not in spans.attribute(events)


def test_every_name_the_harness_reads_is_a_program_span():
    from repro_torch.core.spans import SPANS

    assert set(spans.SPANS) <= set(SPANS)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("hifbench_spans"))


@pytest.mark.parametrize("cell, prefill, decode", [
    ("tiny-dense.chat", {"attn.prefill": 2, "kv.pack": 1, "linear": 12},
     {"attn.decode": 2 * 2, "kv.append": 2 * 2, "lm.head": 2}),
    ("tiny-ssm.chat", {"ssd.scan": 2, "ssm.conv": 2, "lm.head": 1},
     {"ssd.step": 2 * 2, "ssm.conv": 2 * 2, "linear": 2 * 2 * 6}),
])
def test_a_traced_tiny_serve_records_the_spans(tree, cell, prefill, decode,
                                              monkeypatch):
    """The harness's traced call on the CPU (no device: no op, no launch),
    two decode steps of a 2-layer model: each span once a layer a step."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    c = Cell(cell, tree)
    prog = Program(c.config, "cpu")
    prog.load(2 ** 33 + 30)
    tokens = torch.randint(0, prog.numbers["vocab"], (4, 16),
                           generator=torch.Generator().manual_seed(0))
    with trace.TracedCall(2) as traced:
        prog.serve(tokens, 6, {})
    found = spans.attribute(traced.events)
    calls = {phase: {n: r["calls"] for n, r in table.items()}
             for phase, table in found.items()}
    assert calls["prefill"]["lm.prefill"] == 1
    assert calls["decode"]["lm.decode_step"] == 2
    for name, n in prefill.items():
        assert calls["prefill"][name] == n, name
    for name, n in decode.items():
        assert calls["decode"][name] == n, name


def test_span_report_derives_its_numbers_from_one_traced_call():
    """``hifbench/span_report.py``'s numbers on made-up events: the decode
    phase of :data:`EVENTS` over two steps, then a prefill [200, 300] whose
    attention launched one 42 us op and whose scan one of 8 us."""
    from hifbench import span_report
    from hifbench.tests.tiny import DENSE

    events = EVENTS + [
        _ev(trace.PREFILL, 200, 300), _ev("lm.prefill", 201, 260),
        _ev("attn.prefill", 210, 220), _ev("ssd.scan", 230, 240),
        _ev("cudaLaunchKernel", 212, 213, corr=11),
        _ev("cudaLaunchKernel", 232, 233, corr=12),
        _ev("flash", 220, 262, CUDA, corr=11), _ev("scan", 262, 270, CUDA, corr=12)]
    found = trace.analyze(events, top=10 ** 6)
    found["decode_steps"] = 2
    table = spans.attribute(events)
    got = span_report.derived(found, table, DENSE, 1, 16)
    assert got["attributed_over_kernel"] == {"prefill": 1.0, "decode": 1.0}
    assert got["ssd.step_device_ms"] == pytest.approx(10 / 2 / 1e3)
    assert got["ssd.scan_device_us_per_token"] == pytest.approx(8 / 16)
    # 2 layers x 4 B H Dh S(S+1)/2 = 139 264 operations in 42 us
    assert got["attn.prefill_roofline"] == pytest.approx(
        100 * 139264 / 989e12 / 42e-6)
    # the window 0-300 is idle 30+20+6+25 us in the decode phase, 97-220
    # across the phases and 270-300 after the scan: the last two (153 us)
    # hold no host op
    idle = found["window_s"] - found["busy_s"]
    assert idle == pytest.approx((81 + 123 + 30) / 1e6)
    assert got["no_host_op_idle_pct"] == pytest.approx(100 * 153e-6 / idle)
    assert "attn.prefill_roofline" not in span_report.derived(
        found, table, {**DENSE, "family": "ssm"}, 1, 16)
