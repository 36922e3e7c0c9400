"""The yardstick's arithmetic and inputs: counts against hand counts, the
traffic generator's determinism, the loader finding new files by name."""
import json

import pytest

from hifbench import counts
from hifbench.harness import readers, traffic
from hifbench.harness.spec import ROOT, Cell
from hifbench.reference import model as reference
from hifbench.tests.tiny import write_tree


def _model(name):
    return json.loads((ROOT / "hifbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


def test_nemotron_decode_step_against_hand_counts():
    m = _model("nemotron-4-340b-l4")
    per_layer = (2 * 18432 * 18432 + 2 * 18432 * 1536        # q, o; k, v
                 + 2 * 18432 * 73728)                        # FFN in, out
    w = counts.decode_step(m, 32, 400)
    assert w["packed_ops"] == 2 * 32 * 4 * per_layer
    kv_token = 2 * 24 * 36                                   # K + V, 24 groups
    assert w["bytes"] == (0.5625 * 4 * per_layer + 2 * 18432 * 256000
                          + 2 * 32 * 18432 + 4 * 32 * kv_token * (400 + 1)
                          + 4 * 4 * 32 * 96 * 192)           # q read, out written
    assert w["other_ops"] == (2 * 32 * 18432 * 256000
                              + 4 * 4 * 32 * 96 * 192 * 400)
    # the least time is the bytes': ~17.3 GB at 3.35 TB/s
    assert counts.least_time_s(w) == pytest.approx(w["bytes"] / 3.35e12)


def test_mamba2_state_and_prefill_against_hand_counts():
    m = _model("mamba2-1.3b")
    state = 4 * 64 * 64 * 128 + 2 * 3 * (4096 + 256)         # f32 SSD, bf16 conv
    lin = 2048 * (2 * 4096 + 2 * 128 + 64) + 4096 * 2048
    w = counts.decode_step(m, 256, 300)
    assert w["bytes"] == (0.5625 * 48 * lin + 2 * 2048 * 50288 + 2 * 256 * 2048
                          + 48 * 2 * 256 * state)
    assert 52.1e9 < 48 * 2 * 256 * state < 52.2e9           # ~52 GB a step
    p = counts.prefill(m, 2, 1024)
    assert p["packed_ops"] == 2 * 2 * 1024 * 48 * lin
    assert counts.packed_matmul_bound_s(m, 256) == pytest.approx(48 * sum(
        max(2 * 256 * k * n / 1979e12,
            (2 * 256 * k + 0.5625 * k * n + 2 * 256 * n) / 3.35e12)
        for k, n in ((2048, 4096), (2048, 4096), (2048, 128), (2048, 128),
                     (2048, 64), (4096, 2048))))


@pytest.mark.parametrize("mix", ["chat-b32", "chat-b256", "longdoc-b1",
                                 "longdoc-b2"])
def test_traffic_is_the_seeds_and_the_same_work(mix):
    m = json.loads((ROOT / "hifbench" / "traffic" / f"{mix}.json").read_text())
    seed = 2 ** 33 + 7
    a = traffic.prompts(m, seed, 3, 1000)
    assert a.equal(traffic.prompts(m, seed, 3, 1000))
    assert not a.equal(traffic.prompts(m, seed + 1, 3, 1000))
    n = m["prompt"]["levels"]
    for s in (seed, seed + 1):              # every cycle serves every length
        assert sorted(traffic.prompt_len(m, s, i) for i in range(n, 2 * n)) \
            == sorted(traffic.lengths(m))
    assert max(traffic.lengths(m)) == traffic.longest(m) <= m["prompt"]["high"]


def test_loader_finds_new_files_by_name(tmp_path):
    root = write_tree(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "test.calls", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "serve loop",
        "moves": "output_tokens_per_s.ssm", "workloads": ["tiny-ssm.chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "hifbench" / "metrics" / "test.calls.py").write_text(
        "def read(record):\n    return len(record['calls'])\n")
    cell = Cell("tiny-ssm.chat", root)
    assert cell.config["arch"] == "mamba2-1.3b" and cell.mix["batch"] == 4
    assert cell.judge["sample_requests"] == 8
    names = [m["name"] for m in cell.per_layer]
    assert "test.calls" in names and "serve.prefill_ms_p50" not in names
    assert cell.reader("test.calls")({"calls": [1, 2, 3]}) == 3
    assert [m["name"] for m in Cell("tiny-dense.doc", root).end_to_end] == [
        "prompt_tokens_per_s", "ttft_ms_p95", "setup_s"]
    # a metric under a further name reads with the reader of its stem
    calls = [{"batch": 2, "new_tokens": 1, "wall_s": s} for s in (0.1, 0.3)]
    assert cell.reader("ttft_ms_p95.ssm")({"calls": calls}) == 300.0
    with pytest.raises(FileNotFoundError):
        cell.reader("no_such_metric.ssm")


@pytest.mark.parametrize("module", [counts, reference])
def test_families_are_found_by_name(module):
    assert module.family({"family": "ssm"}).__name__.endswith(".ssm")
    with pytest.raises(ValueError, match="family 'moe'"):
        module.family({"family": "moe"})


def test_readers_percentile_and_phases():
    assert readers.percentile(list(range(1, 101)), 0.95) == 95
    assert readers.percentile([3.0], 0.5) == 3.0
    record = {"trace": {"phases": {"decode": {"wall_us": 200.0, "busy_us": 150.0,
                                              "launches": 10, "kernel_us": {}}}}}
    assert readers.idle_pct(record, "decode") == 25.0
    assert readers.idle_pct(record, "prefill") is None
