"""Emit a searched assignment as QuantPolicy JSON + the calibration report
(port of ``repro/calibrate/emit.py``: the same JSON, ``indent=2`` and sorted
keys, so a policy file emitted by either package loads in the other's
``get_policy``).

The emitted policy is a plain, hand-editable policy file:

* a catch-all ``{"pattern": "*", "fmt": "none"}`` base rule, then one
  exact-path rule per site the search quantizes — later-rules-win
  inheritance, same as the hand-written presets;
* ``impl`` is deliberately left off every rule so the serving-side
  ``--impl`` flag keeps working (``get_policy`` prepends it as a base
  rule for file policies);
* ``provenance`` stamps how the placement was chosen (arch, calibration
  set, target and achieved bytes/value) so the policy file — and any
  serving artifact it rides in — is auditable.

The report (``calibration_report.json``) is the full audit trail: every
per-site per-format score the probe measured, the complete
accuracy-vs-bytes Pareto curve the search walked, and the baseline
preset comparisons scored on the same table.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.core.kvcache import KVCacheConfig
from repro_torch.core.policy import QuantPolicy, QuantRule

REPORT_VERSION = 1


def emit_policy(assignment: dict, *, name: str = "searched",
                kv_format: str = "bf16", provenance: Optional[dict] = None,
                out: Optional[str] = None) -> QuantPolicy:
    """Build (and optionally write) the QuantPolicy for an assignment.

    ``assignment`` maps site path -> format name; ``bf16``/``none`` sites
    fall through to the catch-all rule and get no rule of their own.
    """
    rules = [QuantRule("*", fmt="none")]
    for path in sorted(assignment):
        fmt = assignment[path]
        if fmt not in ("bf16", "none"):
            rules.append(QuantRule(path, fmt=fmt))
    pol = QuantPolicy(rules=tuple(rules), kv=KVCacheConfig(kv_format),
                      name=name)
    if provenance is not None:
        pol = pol.with_provenance(provenance)
    if out is not None:
        with open(out, "w") as f:
            json.dump(pol.to_json_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
    return pol


def emit_report(result, frontier, *, target_bpv: float,
                baselines: Optional[dict] = None,
                out: Optional[str] = None) -> dict:
    """Assemble (and optionally write) ``calibration_report.json``.

    ``result`` is the probe's CalibrationResult, ``frontier`` the search's
    FrontierResult; ``baselines`` maps a preset name to its
    ``{assignment, total_bytes, total_error, achieved_bpv}`` scored on the
    same table (``repro_torch.calibrate.search.assignment_cost``).
    """
    report = {
        "version": REPORT_VERSION,
        "arch": result.arch,
        "family": result.family,
        "calibration": {
            "n_batches": result.n_batches,
            "batch": result.batch,
            "seq_len": result.seq_len,
            "seed": result.seed,
            "n_calib_rows": result.n_calib_rows,
        },
        "mem_bw_gbps": (None if result.mem_bw is None
                        else round(result.mem_bw / 1e9, 3)),
        "target_bpv": target_bpv,
        "search": {
            "assignment": dict(sorted(frontier.assignment.items())),
            "total_bytes": round(frontier.total_bytes),
            "total_error": frontier.total_error,
            "achieved_bpv": round(frontier.achieved_bpv, 6),
            "feasible": frontier.feasible,
        },
        "pareto_curve": list(frontier.curve),
        "sites": [dict(r) for r in result.rows],
        "baselines": baselines or {},
    }
    if out is not None:
        with open(out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    return report
