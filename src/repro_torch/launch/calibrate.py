"""Calibration launcher of the PyTorch port: search a QuantPolicy on the
accuracy-bytes frontier (port of ``repro.launch.calibrate``).

    PYTHONPATH=src python -m repro_torch.launch.calibrate --arch qwen1.5-0.5b \\
        --target-bpv 0.7 --out policy.json                       # on cuda
    PYTHONPATH=src python -m repro_torch calibrate --arch qwen1.5-0.5b \\
        --reduced --device cpu --target-bpv 0.9 --out policy.json

Runs the sensitivity probe (one bf16 forward over the calibration batches
with the per-site activation tap), the greedy frontier search at
``--target-bpv``, and emits a provenance-stamped QuantPolicy JSON that
either package's serving entry accepts verbatim:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --policy policy.json --impl packed --kv-format hif4 ...

The weights are the serve launcher's for the same ``--seed`` (random,
made from it). ``--report`` additionally writes
``calibration_report.json``: every per-site per-format score, the full
Pareto curve, and the hand-written preset baselines priced on the same
calibration set. ``--measure-bw`` measures the card's stream bandwidth
first so the report includes each site's roofline latency contribution.
Exits with 2 when the target is below the cheapest assignment.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="search a QuantPolicy from calibration activations")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--target-bpv", type=float, default=0.7,
                    help="byte budget, bytes/value at rest over the "
                         "policy-governed weight sites (hif4 packed = "
                         "0.5625, bf16 = 2.0)")
    ap.add_argument("--calib-batches", type=int, default=2,
                    help="calibration batches to probe")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-format", default="bf16", choices=("bf16", "hif4"),
                    help="cache-global KV format stamped into the policy")
    ap.add_argument("--out", default="policy.json",
                    help="searched QuantPolicy JSON (serve with --policy)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="also write the full calibration_report.json")
    ap.add_argument("--measure-bw", action="store_true",
                    help="measure stream bandwidth for roofline columns")
    ap.add_argument("--device", default="cuda",
                    help="where the probe runs (cuda, or cpu when asked)")
    args = ap.parse_args(argv)

    from repro_torch.calibrate import calibrate

    summary = calibrate(
        args.arch, reduced=args.reduced, target_bpv=args.target_bpv,
        n_batches=args.calib_batches, batch=args.batch,
        seq_len=args.seq_len, seed=args.seed, kv_format=args.kv_format,
        out=args.out, report_out=args.report, measure_bw=args.measure_bw,
        device=args.device)

    print(f"\n== searched policy: {summary['arch']} @ "
          f"{args.target_bpv} B/value ==")
    print(f"{'site':24} {'fmt':8}")
    for path, fmt in summary["assignment"].items():
        print(f"{path:24} {fmt:8}")
    print(f"\nachieved {summary['achieved_bpv']} B/value "
          f"({summary['total_bytes']} B over {summary['n_sites']} sites, "
          f"{summary['n_packed']} packed; feasible={summary['feasible']})")
    for name, b in summary["baselines"].items():
        print(f"baseline {name:20} {b['achieved_bpv']:.5f} B/value  "
              f"error {b['total_error']:.1f}")
    print(f"searched {'':20} {summary['achieved_bpv']:.5f} B/value  "
          f"error {summary['total_error']:.1f}")
    print(f"\nwrote {args.out}"
          + (f" and {args.report}" if args.report else ""))
    if not summary["feasible"]:
        print(f"WARNING: target {args.target_bpv} B/value is below the "
              f"cheapest assignment — emitted the min-bytes policy "
              f"({summary['achieved_bpv']} B/value)")
        raise SystemExit(2)


if __name__ == "__main__":
    main()
