"""``repro_torch.core.spans``: a span is a profiler range only while a
profiler records, and every site in the port names one of :data:`SPANS`."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.core import spans

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    def entered(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    first, second = spans.span("linear"), spans.span("ssd.step")
    assert first is second
    with first:
        pass


def test_under_the_profiler_a_span_is_a_named_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("ssd.step"):
            with spans.span("linear"):
                torch.ones(2).sum()
    names = [e.name for e in prof.events()]
    assert names.count("ssd.step") == 1 and names.count("linear") == 1
    assert spans.span("linear") is spans.span("lm.head")   # off again


@pytest.fixture(scope="module")
def sites():
    """The name of every ``span(...)`` call in the port, a literal each."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "span"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), (path, node.lineno)
                out.append(arg.value)
    return out


@pytest.mark.parametrize("name", spans.SPANS)
def test_every_span_name_has_a_site_and_every_site_a_listed_name(name, sites):
    assert set(sites) <= set(spans.SPANS)
    assert name in sites
