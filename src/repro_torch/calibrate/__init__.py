"""Calibration subsystem: sensitivity-driven automatic QuantPolicy search
(port of ``repro/calibrate``).

Turns a small calibration activation set into a searched
:class:`repro_torch.core.policy.QuantPolicy` on the accuracy-vs-bytes
frontier, in three layers:

probe   (:mod:`repro_torch.calibrate.probe`)  — one bf16 forward over the
        calibration batches with the per-site activation tap installed
        (:mod:`repro_torch.core.tap`), then per-site scores: quantization
        error per format (hif4 / nvfp4 / nvfp4_pts / mxfp4 / bf16, HiF4
        rounded offline with HiGPTQ), byte residency per format, and the
        site's roofline latency contribution.
search  (:mod:`repro_torch.calibrate.search`) — greedy marginal-utility
        sweep over error-per-byte-saved: given a target bytes-per-value
        budget, assign each site the cheapest format whose marginal error
        fits; the full Pareto curve is part of the result.
emit    (:mod:`repro_torch.calibrate.emit`)   — a valid QuantPolicy JSON
        (provenance-stamped, loads via either package's ``get_policy`` and
        serves through ``python -m repro_torch.launch.serve --policy``)
        plus a ``calibration_report.json`` recording every per-site score.

CLI: ``python -m repro_torch calibrate --arch <a> --target-bpv 0.7 --out
policy.json`` (:mod:`repro_torch.launch.calibrate`).
"""
from repro_torch.calibrate.emit import emit_policy, emit_report
from repro_torch.calibrate.probe import CalibrationResult, probe_sites
from repro_torch.calibrate.search import (
    FormatOption,
    FrontierResult,
    SiteScore,
    frontier_search,
)
from repro_torch.calibrate.run import calibrate

__all__ = [
    "CalibrationResult",
    "FormatOption",
    "FrontierResult",
    "SiteScore",
    "calibrate",
    "emit_policy",
    "emit_report",
    "frontier_search",
    "probe_sites",
]
