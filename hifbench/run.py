"""Run one cell of the port's benchmark on the card and print its result.

    python3 hifbench/run.py --workload nemotron-4-340b-l4.chat-b32 \
        --seed 1234 --seconds 45 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown`` of the profiled call, and last ``checks``: each number that
decided ``correct`` beside its limit (also the last lines of standard
error). Exits non-zero, printing no result, without enough CUDA devices, or
if JAX or the JAX package was loaded.
"""
import time

STARTED = time.time()


def _process_age() -> float:
    """Seconds since this process started (Linux), so that set-up counts
    the interpreter's start too."""
    try:
        import os

        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program builds stays at a fixed path in the checkout
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "src" / "repro_torch" / "_build")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".hifbench_cache" / "cuda")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from hifbench.harness.spec import Cell

    chips = Cell(args.workload, ROOT).entry["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hifbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from hifbench.harness import main as harness

    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), started=STARTED - AGE)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"hifbench: the run loaded {', '.join(loaded)}: no result",
              file=sys.stderr)
        return 3
    for key, check in result["checks"].items():
        print(f"check {key} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
