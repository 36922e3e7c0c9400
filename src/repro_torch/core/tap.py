"""Per-site activation tap: capture the inputs quantized matmuls consume
(port of ``repro/core/tap.py``).

The calibration probe (:mod:`repro_torch.calibrate.probe`) needs, for every
quantization site the policy governs, the real activation rows that site's
contraction reads. The tap rides the per-site config path, as the
reference's does:

* :meth:`repro_torch.models.common.ModelCtx.site_quant` MARKS the tap with
  the resolved site path (it is evaluated as an argument of the very
  dense()/qbmm call whose input is wanted);
* the engine funnel (:func:`repro_torch.core.engine.matmul` /
  :func:`~repro_torch.core.engine.qdq_einsum`) CONSUMES the pending mark and
  records the activation operand, flattened to ``(rows, K)`` along the
  contraction axis. The MoE layer, which runs its router and expert
  products on row chunks, consumes once per call on the whole buffer,
  before it chunks, in the reference's (batch, expert, capacity) row order.

The forward walks its layers in a Python loop, so a stacked block site
records one entry per layer, in layer order (entry ``b*L + l`` of a site's
record list is batch ``b``, layer ``l``). Captured rows stay float32 tensors
on the activation's own device: no host copy and no synchronize during the
forward. A tap reached while the current CUDA stream is being captured into
a graph raises (the counterpart of the reference's tracer check: a replay
would record nothing). Expected contraction widths (``expect_k``) guard
against mis-attribution from a stale mark: a ``site_quant`` call with no
following matmul leaves a pending path that the next funnel entry would
otherwise adopt, and a record whose width disagrees is dropped.

Without an installed tap each hook is one global read.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_ACTIVE: Optional["ActivationTap"] = None


class ActivationTap:
    """Accumulates per-site activation rows during a forward.

    ``expect_k`` maps site path -> contraction width K; records whose
    flattened row width disagrees are dropped (stale-mark guard).
    ``max_rows`` caps the rows kept per record (deterministic stride
    subsample) so long prompts don't balloon device memory.
    """

    def __init__(self, expect_k: Optional[dict] = None, max_rows: int = 512):
        self.expect_k = dict(expect_k or {})
        self.max_rows = max_rows
        self.records: dict = {}      # path -> [tensor (rows, K) f32, ...]
        self._pending: Optional[str] = None

    def mark(self, path: str) -> None:
        self._pending = path

    def consume(self, x: torch.Tensor, contract_axis: int) -> None:
        path, self._pending = self._pending, None
        if path is None:
            return
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "ActivationTap reached during CUDA graph capture: run the "
                "probe forward eagerly (a replay would record nothing)")
        rows = torch.movedim(x.detach(), contract_axis, -1)
        rows = rows.reshape(-1, rows.shape[-1])
        want = self.expect_k.get(path)
        if want is not None and rows.shape[1] != want:
            return                     # stale mark: widths disagree, drop
        if rows.shape[0] > self.max_rows:
            stride = -(-rows.shape[0] // self.max_rows)
            rows = rows[::stride]
        self.records.setdefault(path, []).append(
            rows.to(torch.float32, copy=True))

    def paths(self) -> list:
        return sorted(self.records)

    def rows(self, path: str, layer: Optional[int] = None,
             n_layers: int = 1) -> torch.Tensor:
        """Pooled ``(n, K)`` rows for ``path``. Stacked sites record one
        entry per layer per forward (layer-major within a forward);
        ``layer``/``n_layers`` select one layer's entries, ``layer=None``
        pools all of them."""
        recs = self.records[path]
        if layer is not None:
            recs = recs[layer::n_layers]
        return torch.cat(recs, dim=0)


def active() -> Optional[ActivationTap]:
    return _ACTIVE


def mark_site(path: str) -> None:
    """No-op unless a tap is installed (the ModelCtx.site_quant hook)."""
    if _ACTIVE is not None:
        _ACTIVE.mark(path)


def consume_pending(x: torch.Tensor, contract_axis: int) -> None:
    """No-op unless a tap is installed (the engine-funnel hook)."""
    if _ACTIVE is not None:
        _ACTIVE.consume(x, contract_axis)


@contextlib.contextmanager
def capture(t: ActivationTap):
    """Install ``t`` for the duration of a probe forward (not reentrant)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("an ActivationTap is already installed")
    _ACTIVE = t
    try:
        yield t
    finally:
        _ACTIVE = None
