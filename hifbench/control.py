"""The control's readings and the program's, over many seeds in one process.

    python3 hifbench/control.py --workload mamba2-1.3b.chat-b256 \
        --seeds 11,12,13 --seconds 5

For each seed: draw and pack the weights, serve a short window of the
cell's traffic, and judge a sample as a run does, judging beside the
program the control (the reference computed in fp8 where the configuration
stores bf16) by the same limits: ``correct`` is the program's verdict,
``control_correct`` the control's, which has to come out false. Prints one
JSON line a seed, with every number either side reads, compared or not.
The limits in ``hifbench/cells/`` are set from these readings; the
benchmark's own runs never run the control.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "src" / "repro_torch" / "_build")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".hifbench_cache" / "cuda")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="a tree holding BENCHMARK.json and hifbench/ data "
                         "files (another cut of a configuration, say)")
    args = ap.parse_args(argv)

    from hifbench.harness import main as harness
    from hifbench.harness.program import Program
    from hifbench.harness.spec import Cell

    root = Path(args.root)
    prog = Program(Cell(args.workload, root).config, args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        res = harness.run(args.workload, seed, args.seconds, False,
                          device=args.device, root=root, control=True,
                          program=prog)
        d = res["detail"]
        print(json.dumps({
            "seed": seed, "correct": res["correct"],
            "control_correct": res["control_correct"],
            "checks": res["checks"], "control_checks": d["control_checks"],
            "numbers": d["numbers"], "control_numbers": d["control_numbers"],
            "served_tokens": d["served_tokens_judged"], "calls": d["calls"],
            "gaps": d["gaps"], "control_gaps": d["control_gaps"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "memory_peak_bytes": res["device"]["memory_peak_bytes"],
            "reference_s": d["reference_s"], "seconds": time.time() - t0}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
