"""Where a dry-run cell's bytes and FLOPs live (the counterpart of
``repro/launch/breakdown.py``).

The reference ranks the computations of a compiled cell by bytes, each times
its loop multiplicity, then lists the top instructions inside. Here a
region is the port function that issued the aten ops (the innermost frame
of ``repro_torch`` under the dispatch), costed loop-aware like the dry run
(:mod:`repro_torch.launch.cost_analysis`), with its multiplicity: the depth
it repeats with (the layers, or 1 for once a step). Then the top aten ops
inside the first three regions. Runs on ``meta``; no card is needed.

  python -m repro_torch breakdown --arch qwen1.5-0.5b --shape decode_32k
"""
from __future__ import annotations

import argparse


def region_table(cost, mult: dict) -> list:
    """[(bytes, flops, ops, multiplicity, region)], most bytes first."""
    rows = [(b, f, n, mult.get(r, 1), r) for r, (b, f, n) in cost.regions.items()]
    rows.sort(key=lambda r: (r[0], r[1], r[2]), reverse=True)
    return rows


def op_table(cost, region: str) -> list:
    """[(bytes, flops, ops, aten op)] of one region, most bytes first."""
    rows = [(b, f, n, op) for (r, op), (b, f, n) in cost.region_ops.items()
            if r == region]
    rows.sort(key=lambda r: (r[0], r[1], r[2]), reverse=True)
    return rows


def print_breakdown(cost, mult: dict, n_regions: int = 8, n_ops: int = 6) -> None:
    rows = region_table(cost, mult)
    print(f"{'GiB':>10} {'GFLOP':>12} {'ops':>10} {'mult':>5}  region")
    for b, f, n, m, r in rows[:n_regions]:
        print(f"{b / 2**30:10.2f} {f / 1e9:12.1f} {n:10d} {m:5d}  {r}")
    for b, f, n, m, r in rows[:3]:
        print(f"\n--- {r} (mult={m})")
        for ob, of, on, op in op_table(cost, r)[:n_ops]:
            print(f"  {ob / 2**20:12.1f}MiB {of / 1e9:10.1f}GFLOP {on:8d}x {op}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch breakdown",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--quant", default="hif4")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import lower_cell

    rec, cost, mult = lower_cell(args.arch, args.shape, quant=args.quant,
                                 packed=args.packed,
                                 microbatches=args.microbatches, regions=True)
    r, m = rec["roofline"], rec["memory"]
    print(f"{args.arch} x {args.shape} (meta, {rec['cost_s']} s): "
          f"t_comp={r['t_compute_s'] * 1e3:.1f}ms "
          f"t_mem={r['t_memory_s'] * 1e3:.1f}ms dom={r['dominant']} "
          f"useful={rec['useful_flops_ratio']:.2f} "
          f"peak={m['peak_bytes_est'] / 2**30:.2f}GiB\n")
    print_breakdown(cost, mult)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
