"""Frontier search: assign each site the cheapest format whose error fits
(port of ``repro/calibrate/search.py``, the same arithmetic line for line).

Pure arithmetic over a per-site score table — no model, no activations —
so the search is property-testable in isolation
(tests/test_torch_calibrate.py drives it with random tables and holds it
to the reference's on the same tables).

Every site offers a set of :class:`FormatOption`\\ s (format name, bytes
per value at rest, measured error). The search:

1. drops dominated options per site (another option with <= bytes and
   <= error) and keeps the lower convex hull of the survivors in
   (bytes, error) space — ratios between consecutive hull points are
   then non-decreasing as bytes shrink;
2. starts every site at its max-bytes / min-error hull point and lists
   each site's hull steps as candidate MOVES, priced at marginal
   weighted-error per byte saved;
3. applies moves globally cheapest-first (deterministic tie-break on
   site path) until the byte budget ``target_bpv * total_values`` is
   met, recording the full Pareto curve along the way.

Because the applied move sequence is a PREFIX of one fixed global order,
raising ``target_bpv`` can only shorten the prefix: total error is
monotone non-increasing and total bytes monotone non-decreasing in the
target — the property the hypothesis test pins.

A site's ``weight`` (default: its value count) scales its error into the
objective, so a 1% output error on a 65k-value projection outweighs the
same error on a tiny router.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class FormatOption:
    """One residency choice for a site: ``fmt`` at ``bytes_per_value``
    costing ``error`` (any non-negative score; the probe uses relative
    layer-output error)."""

    fmt: str
    bytes_per_value: float
    error: float


@dataclasses.dataclass(frozen=True)
class SiteScore:
    """One site's row of the score table."""

    path: str
    n_values: int
    options: tuple  # tuple[FormatOption, ...], at least one
    weight: Optional[float] = None  # objective scale; default n_values

    @property
    def w(self) -> float:
        return float(self.n_values if self.weight is None else self.weight)


@dataclasses.dataclass(frozen=True)
class FrontierResult:
    """The searched assignment plus the Pareto curve that led to it.

    assignment   : {site path: chosen format name}
    total_bytes  : bytes at rest under the assignment
    total_error  : sum of weighted site errors under the assignment
    achieved_bpv : total_bytes / total values
    feasible     : the byte budget was met (False = even the cheapest
                   assignment exceeds it; the cheapest is returned)
    curve        : [{bpv, total_bytes, total_error, moved, fmt}] — entry 0
                   is the all-min-error start, one entry per applied move
                   when infeasible/exact, the full move list otherwise
                   (the complete accuracy-vs-bytes frontier artifact)
    """

    assignment: dict
    total_bytes: float
    total_error: float
    achieved_bpv: float
    feasible: bool
    curve: tuple


def _hull(options: Sequence[FormatOption]) -> list:
    """Dominance-filtered lower convex hull, max-bytes first.

    Input options are arbitrary; output is ordered by strictly decreasing
    bytes_per_value with strictly increasing error, and consecutive
    error-per-byte-saved ratios non-decreasing (convexity) — the shape
    the prefix-monotone greedy needs."""
    # dominance filter: keep the min-error option at each bytes level,
    # then drop any option beaten on both axes
    best_at = {}
    for o in options:
        cur = best_at.get(o.bytes_per_value)
        if cur is None or (o.error, o.fmt) < (cur.error, cur.fmt):
            best_at[o.bytes_per_value] = o
    cands = sorted(best_at.values(),
                   key=lambda o: (-o.bytes_per_value, o.error, o.fmt))
    undominated = []
    for o in cands:  # bytes descending: a kept point with >= error is
        while undominated and undominated[-1].error >= o.error:  # dominated
            undominated.pop()
        undominated.append(o)
    # graham-scan style convexification in (bytes, error), bytes desc
    hull: list = []
    for o in undominated:
        while len(hull) >= 2:
            a, b = hull[-2], hull[-1]
            # slope of a->b vs a->o (error rise per byte saved); keep b
            # only if it bends the right way (convex)
            lhs = (b.error - a.error) * (a.bytes_per_value - o.bytes_per_value)
            rhs = (o.error - a.error) * (a.bytes_per_value - b.bytes_per_value)
            if lhs >= rhs:
                hull.pop()
            else:
                break
        hull.append(o)
    return hull


def frontier_search(sites: Sequence[SiteScore],
                    target_bpv: float) -> FrontierResult:
    """Greedy marginal-utility frontier search (see module docstring)."""
    assert sites, "frontier_search needs at least one site"
    hulls = {s.path: _hull(s.options) for s in sites}
    n_total = sum(s.n_values for s in sites)
    budget = target_bpv * n_total

    # start: every site at its min-error (= max-bytes hull) point
    assignment = {s.path: hulls[s.path][0].fmt for s in sites}
    total_bytes = sum(hulls[s.path][0].bytes_per_value * s.n_values
                      for s in sites)
    total_error = sum(hulls[s.path][0].error * s.w for s in sites)

    # candidate moves: each site's hull steps, priced marginally. Within a
    # site, convexity makes ratios non-decreasing, so a global sort keeps
    # per-site order — the applied sequence is a prefix of one fixed list.
    moves = []
    for s in sites:
        h = hulls[s.path]
        for i in range(1, len(h)):
            d_bytes = (h[i - 1].bytes_per_value
                       - h[i].bytes_per_value) * s.n_values
            d_error = (h[i].error - h[i - 1].error) * s.w
            moves.append((d_error / d_bytes, s.path, i, d_bytes, d_error,
                          h[i].fmt))
    moves.sort(key=lambda m: (m[0], m[1], m[2]))

    curve = [{"bpv": round(total_bytes / n_total, 6),
              "total_bytes": total_bytes, "total_error": total_error,
              "moved": None, "fmt": None}]
    met = total_bytes <= budget
    for _ratio, path, _i, d_bytes, d_error, fmt in moves:
        # the curve walks EVERY move (the full frontier is an artifact);
        # the assignment only follows it until the budget is met
        total_b = curve[-1]["total_bytes"] - d_bytes
        total_e = curve[-1]["total_error"] + d_error
        curve.append({"bpv": round(total_b / n_total, 6),
                      "total_bytes": total_b, "total_error": total_e,
                      "moved": path, "fmt": fmt})
        if not met:
            assignment[path] = fmt
            total_bytes -= d_bytes
            total_error += d_error
            met = total_bytes <= budget
    feasible = met
    return FrontierResult(
        assignment=assignment,
        total_bytes=total_bytes,
        total_error=total_error,
        achieved_bpv=total_bytes / n_total,
        feasible=feasible,
        curve=tuple(curve),
    )


def assignment_cost(sites: Sequence[SiteScore], assignment: dict) -> tuple:
    """(total_bytes, total_error) of an explicit {path: fmt} assignment —
    used to score a hand-written preset on the same table the search ran
    on. Falls back to a site's min-error option when the assignment names
    a format the site has no option for."""
    total_b = total_e = 0.0
    for s in sites:
        by_fmt = {o.fmt: o for o in s.options}
        o = by_fmt.get(assignment.get(s.path))
        if o is None:
            o = min(s.options, key=lambda o: (o.error, o.bytes_per_value))
        total_b += o.bytes_per_value * s.n_values
        total_e += o.error * s.w
    return total_b, total_e
