"""A traced run of one cell, its profiled call's device time, launches and
idle gaps attributed to the program's spans.

    python3 hifbench/span_report.py --workload mamba2-1.3b.chat-b256 \
        --seed 1234 --seconds 45

Runs the cell as ``hifbench/run.py --trace 1`` does (the same set-up,
window, profiled call and judgement), keeps the profiled call's events and
prints one JSON line: the run's ``correct``, ``metrics``, ``device`` and
``breakdown`` as ``run.py`` prints them; ``spans``, per phase and span
name, from :func:`hifbench.harness.spans.attribute`; and ``derived``:

  attributed_over_kernel  per phase, the device time over every span and
                          ``(none)`` / the sum of the phase's ``kernel_us``
  ssd.step_device_ms      ``ssd.step``'s decode device time a profiled step
  ssd.scan_device_us_per_token  ``ssd.scan``'s prefill device time / the
                          traced call's batch x prompt length
  attn.prefill_roofline   the traced prefill's causal attention operations
                          (``counts`` ``prefill_work``) at the bf16 peak /
                          ``attn.prefill``'s prefill device time, in %
  no_host_op_idle_pct     the idle gaps ``analyze`` names ``(no host op)``
                          / the traced window's idle time, in %

each where the run has it. An operator's tool beside the benchmark: its
runs do not call it, and it reads no metric they report.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "src" / "repro_torch" / "_build")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".hifbench_cache" / "cuda")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def derived(found: dict, spans: dict, m: dict, batch: int, S: int) -> dict:
    """The numbers of the module docstring's ``derived`` from one traced
    call: ``found`` from ``trace.analyze`` (every idle gap kept), ``spans``
    from ``spans.attribute``, ``m`` the configuration's model numbers."""
    from hifbench import counts

    out = {"attributed_over_kernel": {
        phase: (sum(r["device_us"] for r in table.values())
                / sum(found["phases"][phase]["kernel_us"].values()))
        for phase, table in spans.items()
        if sum(found["phases"][phase]["kernel_us"].values()) > 0}}
    step = spans.get("decode", {}).get("ssd.step")
    if step and found.get("decode_steps"):
        out["ssd.step_device_ms"] = step["device_us"] / found["decode_steps"] / 1e3
    scan = spans.get("prefill", {}).get("ssd.scan")
    if scan:
        out["ssd.scan_device_us_per_token"] = scan["device_us"] / (batch * S)
    attn = spans.get("prefill", {}).get("attn.prefill")
    if attn and attn["device_us"] > 0 and m["family"] == "dense":
        ops, _ = counts.family(m).prefill_work(m, batch, S)
        out["attn.prefill_roofline"] = (100.0 * ops / counts.PEAK_BF16_FLOPS
                                        / (attn["device_us"] / 1e6))
    idle_s = found.get("window_s", 0.0) - found.get("busy_s", 0.0)
    if idle_s > 0:
        gaps = dict(found["breakdown"]["idle_gaps"])
        out["no_host_op_idle_pct"] = 100.0 * gaps.get("(no host op)", 0.0) / idle_s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from hifbench.harness import main as harness
    from hifbench.harness import spans, trace, traffic
    from hifbench.harness.spec import Cell

    kept = []

    class Kept(trace.TracedCall):
        """The harness's traced call, its events kept for this report."""

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out

    trace.TracedCall = Kept
    result = harness.run(args.workload, args.seed, args.seconds, True)
    report = {k: result[k] for k in ("correct", "metrics", "device", "breakdown")
              if k in result}
    report["seed"] = args.seed
    if kept:
        cell = Cell(args.workload)
        found = trace.analyze(kept[0].events, top=10 ** 6)
        found["decode_steps"] = kept[0].decode_steps
        table = spans.attribute(kept[0].events)
        S = traffic.prompt_len(cell.mix, args.seed, harness.TRACED_CALL)
        report["spans"] = table
        report["derived"] = derived(found, table, cell.config["model"],
                                    cell.mix["batch"], S)
        report["traced_call"] = {"batch": cell.mix["batch"], "prompt_len": S,
                                 "decode_steps": kept[0].decode_steps}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
