"""HiGPTQ: GPTQ tailored to the HiF4 block floating-point structure (§IV-A)
(port of ``repro/core/higptq.py``).

Vanilla GPTQ quantizes a weight matrix one contraction index at a time,
compensating the not-yet-quantized rows through the inverse Hessian of the
layer's calibration activations. The HiF4 adaptations:

  * the quantization grid is HiF4's: at each 64-row group boundary the
    three-level scaling metadata (E6M2 + micro-exponents) is derived from
    the CURRENT error-compensated weights of that group
    (:func:`repro_torch.core.hif4.quantize_groups`, Algorithm 1 bit for
    bit), then frozen;
  * within the group, each row is rounded onto its element's effective
    grid quantum = E6M2 * 2^(E1_8 + E1_16) * 0.25, clamped at +-7 quanta
    (the S1P2 bound), with the rounding error propagated GPTQ-style.

Orientation: W is (K, N) with K the contraction dim (HiF4 groups along K);
X is (n_samples, K). Everything runs in float32 on the weight's device, in
the reference's order: ``inv`` of the damped Hessian, its upper Cholesky
factor, then per row the whole update of the rows after it. The row loop
is one launch per step and is bound by the host, so a stacked site's
layers run it together (:func:`higptq_quantize_layers`).
"""
from __future__ import annotations

import torch

from repro_torch.core import hif4
from repro_torch.core import rounding as R
from repro_torch.core.metrics import rel_output_error

GROUP = hif4.GROUP_SIZE


def hessian_from_activations(x: torch.Tensor, damp: float = 0.01
                             ) -> torch.Tensor:
    """H = X^T X / n + damp * mean(diag) * I, in float32, for x (n, K) or a
    stack of layers (L, n, K). The division is by a tensor: by a Python
    number CUDA multiplies by its reciprocal."""
    x = x.to(torch.float32)
    n = torch.tensor(float(x.shape[-2]), device=x.device)
    h = x.transpose(-2, -1) @ x / n
    d = torch.mean(torch.diagonal(h, dim1=-2, dim2=-1), dim=-1)
    eye = torch.eye(h.shape[-1], dtype=torch.float32, device=x.device)
    return h + (damp * torch.clamp_min(d, 1e-8))[..., None, None] * eye


def _group_grid(wg: torch.Tensor) -> torch.Tensor:
    """HiF4 metadata for one group. wg (..., 64, N) -> quantum (..., 64, N)
    f32, from Algorithm 1's scale derivation on the transposed group, so
    the grid is the direct cast's bit for bit."""
    g = hif4.quantize_groups(wg.transpose(-2, -1).to(torch.float32))
    shift = (torch.repeat_interleave(g.e1_8, 8, dim=-1)
             + torch.repeat_interleave(g.e1_16, 4, dim=-1))   # (..., N, 64)
    quantum = g.e6m2[..., None] * torch.exp2(shift.to(torch.float32)) * R.S1P2_STEP
    return quantum.transpose(-2, -1)


def _quantize_row(w_row: torch.Tensor, quantum: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    q = torch.round(w_row / quantum)
    return torch.clamp(q, -7.0, 7.0) * quantum


def _higptq(w: torch.Tensor, x: torch.Tensor, damp: float) -> torch.Tensor:
    """HiGPTQ of L independent layers at once: w (L, K, N), x (L, n, K) ->
    (L, K, N) float32. Every step is the reference's for each layer (a
    layer's rows never meet another's), one launch for all L."""
    L, K, N = w.shape
    if K % GROUP:
        raise ValueError(f"contraction dim {K} not a multiple of {GROUP}")
    wq = w.to(torch.float32, copy=True)
    h = hessian_from_activations(x.to(wq.device), damp)
    # GPTQ uses the upper Cholesky factor of H^-1, one layer at a time (the
    # single-matrix solvers, not the batched ones)
    u = torch.stack([torch.linalg.cholesky(torch.linalg.inv(h_l), upper=True)
                     for h_l in h])                           # (L, K, K)

    out = torch.empty_like(wq)
    for k0 in range(0, K, GROUP):
        grid = _group_grid(wq[:, k0:k0 + GROUP])              # (L, 64, N)
        for i in range(GROUP):
            k = k0 + i
            w_row = wq[:, k]
            q_row = _quantize_row(w_row, grid[:, i])
            err = (w_row - q_row) / u[:, k, k, None]
            out[:, k] = q_row
            # compensate every later row: w[j] -= U[k, j] * err (j > k); the
            # reference's masked update leaves rows <= k as they are
            wq[:, k + 1:] -= u[:, k, k + 1:, None] * err[:, None, :]
    return out


def higptq_quantize(w: torch.Tensor, x_calib: torch.Tensor, *,
                    damp: float = 0.01) -> torch.Tensor:
    """GPTQ-compensated HiF4 weights (same dtype/shape as ``w``, (K, N)
    contraction-major) from calibration activations (n_samples, K)."""
    return _higptq(w[None], x_calib[None], damp)[0].to(w.dtype)


def higptq_quantize_layers(w_layers: torch.Tensor, x_layers, *,
                           damp: float = 0.01) -> torch.Tensor:
    """HiGPTQ of a stack of independent (K, N) weights (L, K, N), each with
    its own calibration rows (``x_layers``: (L, n, K) or a list of (n_l,
    K)); f32 out. Layers with equally many rows run together, the steps of
    :func:`higptq_quantize` on every layer at once (a full-width stacked
    site takes one launch per step for all its layers, not one per layer)."""
    if len({tuple(x.shape) for x in x_layers}) == 1:
        return _higptq(w_layers, torch.stack(list(x_layers)), damp)
    return torch.stack([_higptq(w[None], x[None], damp)[0]
                        for w, x in zip(w_layers, x_layers)])


def quantize_stacked(w_stacked: torch.Tensor, x_layers, *,
                     n_samples: int = 512, damp: float = 0.01) -> torch.Tensor:
    """HiGPTQ over a stacked block weight (L, K, ...), one layer per calibration
    set (``x_layers``: (L, n, K) or a list of (n, K)). Trailing output dims
    are flattened to N and restored."""
    shape = w_stacked.shape
    w2 = w_stacked.to(torch.float32).reshape(shape[0], shape[1], -1)
    out = higptq_quantize_layers(w2, [x[:n_samples] for x in x_layers],
                                 damp=damp)
    return out.reshape(shape).to(w_stacked.dtype)


def layer_output_error(w_ref: torch.Tensor, w_q: torch.Tensor,
                       x: torch.Tensor) -> float:
    """||X (W - W_q)||_F / ||X W||_F, the metric GPTQ minimizes
    (:func:`repro_torch.core.metrics.rel_output_error`)."""
    return rel_output_error(w_ref, w_q, x)
