"""Error metrics of the cross-format comparison (port of
``repro/core/metrics.py``): MSE, relative MSE, SQNR and max |error| of a
format's direct cast, the per-format table over the paper's comparison set,
and the layer-output error the calibrator ranks sites by."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.formats import get_format

# the cross-format comparison set the paper sweeps (Fig. 3)
QDQ_FORMATS = ("hif4", "nvfp4", "nvfp4_pts", "mxfp4")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def mse(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    d = _f32(x) - _f32(x_hat)
    return torch.mean(d * d)


def rel_mse(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    return mse(x, x_hat) / torch.clamp_min(torch.mean(torch.square(_f32(x))), 1e-30)


def sqnr_db(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / torch.clamp_min(rel_mse(x, x_hat), 1e-30))


def max_abs_err(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(_f32(x) - _f32(x_hat)))


METRICS = {"mse": mse, "rel_mse": rel_mse, "sqnr_db": sqnr_db,
           "max_abs_err": max_abs_err}


def qdq_error(x: torch.Tensor, fmt: Optional[str], metric: str = "mse",
              axis: int = -1) -> float:
    """Direct-cast error of quantizing ``x`` to ``fmt`` (grouped along
    ``axis``) under one of the named :data:`METRICS`. ``fmt='none'`` scores
    zero error (sqnr_db saturates)."""
    f = get_format(fmt)
    x_hat = x if f is None else f.qdq(x, axis=axis)
    return float(METRICS[metric](x, x_hat))


def format_error_table(x: torch.Tensor, formats: Sequence[str] = QDQ_FORMATS,
                       metric: str = "mse", axis: int = -1) -> dict:
    """``{fmt: error}`` over the comparison set (the Fig. 3 inner loop)."""
    return {f: qdq_error(x, f, metric=metric, axis=axis) for f in formats}


def rel_output_error(w_ref: torch.Tensor, w_q: torch.Tensor,
                     x: torch.Tensor) -> float:
    """``||X (W - W_q)||_F / ||X W||_F``: ``w`` is (K, N) contraction-major,
    ``x`` is (n_samples, K)."""
    x = _f32(x)
    num = torch.linalg.norm(x @ (_f32(w_ref) - _f32(w_q)))
    den = torch.linalg.norm(x @ _f32(w_ref))
    return float(num / torch.clamp_min(den, 1e-30))


def agreement(preds: torch.Tensor, ref_preds: Optional[torch.Tensor]) -> float:
    """Fraction of predictions agreeing with a reference run (1.0 without a
    reference)."""
    if ref_preds is None:
        return 1.0
    return float(torch.mean((preds == ref_preds).to(torch.float32)))
