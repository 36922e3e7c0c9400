"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A cell names a configuration and a traffic mix; each lives in a file of its
own (``hifbench/configs/<config>.json``, ``hifbench/traffic/<mix>.json``),
the cell's judging (sample size and limits) in ``hifbench/cells/<cell>.json``
and each metric's reader in ``hifbench/metrics/<metric>.py``. So a later
change adds a cell, a configuration, a mix or a metric by adding files and
entries, and edits none. A metric that reads what another does, under a
name of its own (``ttft_ms_p95.ssm``: the same number in cells held to
another bound, and the per-layer metrics that move it), needs no file: the
reader of the longest leading part of its name that has one reads it.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        bench = _json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        here = self.root / "hifbench"
        self.config = _json(here / "configs" / f"{self.entry['config']}.json")
        self.mix = _json(here / "traffic" / f"{self.entry['traffic']}.json")
        self.judge = _json(here / "cells" / f"{name}.json")
        reports = set()
        self.end_to_end = []
        for met in bench["end_to_end"]:
            if name in met.get("workloads", [name]):
                self.end_to_end.append(met)
                reports.add(met["name"])
        self.per_layer = [met for met in bench["per_layer"]
                          if name in met.get("workloads", [name])
                          and met["moves"] in reports]
        self._metrics_dir = here / "metrics"

    def reader(self, name: str):
        """The ``read(record)`` function of a metric's file."""
        return metric(name, self._metrics_dir)


def metric(name: str, where: Path = ROOT / "hifbench" / "metrics"):
    """The ``read(record)`` function of ``<where>/<name>.py``, or of the
    longest leading part of ``name`` (up to a dot) that has a file: one
    metric's reader, found by its name (a name may hold dots)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        stem = ".".join(parts[:n])
        path = Path(where) / f"{stem}.py"
        if path.is_file():
            break
    else:
        raise FileNotFoundError(f"no reader for metric {name!r} in {where}")
    spec = importlib.util.spec_from_file_location(
        "hifbench_metric_" + stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
