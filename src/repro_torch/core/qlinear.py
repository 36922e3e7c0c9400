"""Quantized linear algebra plumbing (port of ``repro/core/qlinear.py``):
configs, fake-quant ops with their straight-through estimator, ``qmatmul``
and the packed-weight container. The engine (:mod:`repro_torch.core.engine`)
owns execution.

The fake-quant ops return the quantized value. Where autograd records the
operand they return it through the reference's straight-through estimator
(:func:`_ste`): the forward value is the QDQ, the gradient the identity.
Outside grad mode (serving) they return the QDQ itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import hif4
from repro_torch.core.formats import BFPFormat, get_format
from repro_torch.core.kvcache import KVCacheConfig


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How matmuls inside models are quantized.

    fmt             : 'hif4' | 'nvfp4' | 'nvfp4_pts' | 'mxfp4' | 'none'
    weights_only    : quantize only the weight operand
    offline_weights : weights were already quantized once offline; skip
                      the in-graph weight QDQ
    impl            : 'qdq' | 'packed' | 'pallas'
    kv              : how the decode KV cache is stored
    """

    fmt: str = "none"
    weights_only: bool = False
    offline_weights: bool = False
    impl: str = "qdq"
    kv: KVCacheConfig = KVCacheConfig()

    @property
    def enabled(self) -> bool:
        return get_format(self.fmt) is not None

    def format(self) -> Optional[BFPFormat]:
        return get_format(self.fmt)


NO_QUANT = QuantConfig()


def _ste(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward = ``x_hat``, backward = identity.

    The reference's ``x + stop_gradient(x_hat - x)``, evaluated in a wider
    float (f32 for bf16/f16 operands, f64 for f32) and cast back to the
    operand's dtype, as XLA evaluates it: the difference is then exact and
    the sum is ``x_hat``'s value (a QDQ -0 comes back as +0, as in the
    reference). The rounding inside QDQ (``torch.frexp``, ``torch.round``)
    has a zero or no derivative; without the estimator a quantized matmul
    passes no gradient back."""
    wide = torch.float64 if x.dtype in (torch.float32, torch.float64) \
        else torch.float32
    xw = x.to(wide)
    return (xw + (x_hat.to(wide) - xw).detach()).to(x.dtype)


def _fake_quant(x: torch.Tensor, fmt: BFPFormat, axis: int) -> torch.Tensor:
    """QDQ of ``x`` along ``axis``. Where autograd records ``x``, Algorithm 1
    runs on ``x.detach()`` (its ~60 intermediates are never recorded) and
    the result goes through :func:`_ste`."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return fmt.qdq(x, axis=axis)
    return _ste(x, fmt.qdq(x.detach(), axis=axis))


def quantize_activation(x: torch.Tensor, cfg: QuantConfig, axis: int = -1
                        ) -> torch.Tensor:
    fmt = cfg.format()
    if fmt is None or cfg.weights_only:
        return x
    return _fake_quant(x, fmt, axis)


def quantize_weight(w: torch.Tensor, cfg: QuantConfig, axis: int = 0
                    ) -> torch.Tensor:
    fmt = cfg.format()
    if fmt is None or cfg.offline_weights:
        return w
    return _fake_quant(w, fmt, axis)


def packable_contract_axes(key: str, ndim: int):
    """Contraction axes of a STACKED block weight (leading axis = layers):
    attn wo (L, H, Dh, d) contracts (H, Dh); every other weight axis 1."""
    if key == "wo" and ndim == 4:
        return (1, 2)
    return (1,) if ndim >= 3 else (0,)


def _qdq_along(w, fmt, ca: tuple):
    """QDQ ``w`` along contraction axes ``ca`` (multi-axis: flatten, qdq,
    restore); ``w`` unchanged when K is not a whole number of 64-groups."""
    if len(ca) == 1:
        if w.shape[ca[0]] % hif4.GROUP_SIZE:
            return w
        return fmt.qdq(w, axis=ca[0])
    lead = tuple(w.shape[: ca[0]])
    k_flat = math.prod(w.shape[a] for a in ca)
    if k_flat % hif4.GROUP_SIZE:
        return w
    w2 = w.reshape(lead + (k_flat,) + tuple(w.shape[ca[-1] + 1:]))
    return fmt.qdq(w2, axis=len(lead)).reshape(w.shape)


def quantize_params_offline(params, cfg: QuantConfig, *, plan=None,
                            prefix: str = ""):
    """One-time offline weight PTQ: QDQ exactly the matmul weights along their
    contraction axes. With ``plan`` (a resolved QuantPlan) the per-site
    decision comes from the plan; without one, the default packable-site
    rules with ``cfg.fmt``. ``PackedW`` leaves pass through untouched."""
    from repro_torch.core.policy import default_offline_axes

    fmt = cfg.format()
    if fmt is None and plan is None:
        return params

    def q(parts, w):
        if isinstance(w, PackedW):
            return w
        if plan is not None:
            site = plan.get(".".join(([prefix] if prefix else []) + parts))
            if site is None or site.packed or not site.quantize_offline:
                return w
            site_fmt = site.cfg.format()
            if site_fmt is None:
                return w
            return _qdq_along(w, site_fmt, site.contract_axes)
        ca = default_offline_axes(parts[-1], w.ndim)
        if ca is None:
            return w
        return _qdq_along(w, fmt, ca)

    def walk(node, parts):
        if isinstance(node, dict):
            return {k: walk(v, parts + [k]) for k, v in node.items()}
        return q(parts, node)

    return walk(params, [])


def qmatmul(x: torch.Tensor, w, cfg: QuantConfig = NO_QUANT, *,
            contract_x: int = -1, contract_w: int = 0,
            accum_dtype=None) -> torch.Tensor:
    """``x @ w`` with both operands cast to ``cfg.fmt`` along the
    contraction, through :func:`repro_torch.core.engine.matmul` (so
    ``cfg.impl`` picks the path and ``w`` may be a :class:`PackedW`).
    ``accum_dtype`` is the dot's output dtype (default ``x.dtype``)."""
    from repro_torch.core import engine

    return engine.matmul(x, w, engine.EngineCtx(quant=cfg),
                         contract_x=contract_x, contract_w=contract_w,
                         accum_dtype=accum_dtype)


# ---------------------------------------------------------------------------
# Fixed-point dot product (paper Eq. 3 / Fig. 4) — reference-level
# ---------------------------------------------------------------------------


def hif4_dot_fixed_point(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot of two vectors (length a multiple of 64) via the paper's integer
    flow: both quantized to HiF4, micro-exponents absorbed into int8
    elements, an int32 dot per 64-group, then one float multiply by the two
    group scales per group."""
    ga = hif4.quantize_groups(a.reshape(-1, hif4.GROUP_SIZE))
    gb = hif4.quantize_groups(b.reshape(-1, hif4.GROUP_SIZE))
    ia, sa = hif4.to_absorbed_int(ga)
    ib, sb = hif4.to_absorbed_int(gb)
    acc = torch.sum(ia.to(torch.int32) * ib.to(torch.int32), dim=-1)
    return torch.sum(sa * sb * acc.to(torch.float32))


# ---------------------------------------------------------------------------
# Packed weights (serving deployment artifact, 4.5 bits/value)
# ---------------------------------------------------------------------------

# values per slab of PackedW.from_dense (1 GiB of float32): a weight of
# nemotron-4-340b's FFN (1.36 G values) packs in six slabs
PACK_SLAB_VALUES = 2 ** 28


@dataclasses.dataclass
class PackedW:
    """A weight stored as HiF4 packed buffers, usable wherever the models
    pass a dense weight.

    * artifact (``kernel_layout=False``) — output-major, the on-disk shape:
          codes (N, K/64, 32) uint8    meta (N, K/64) int32 (uint32 bits)
    * kernel (``kernel_layout=True``) — K-major 2-D, what the fused matmul
      streams:
          codes (K/2, N) uint8         meta (K/64, N) int32

    Stacked-layer weights carry one extra leading L axis on both buffers
    (:meth:`layer` slices it). ``shape2d`` = (K, N).
    """

    codes: torch.Tensor
    meta: torch.Tensor
    shape2d: tuple
    dtype: Any = torch.bfloat16
    axes2d: tuple = (None, None)     # (out logical axis, contract logical axis)
    kernel_layout: bool = False

    def _replace(self, **kw) -> "PackedW":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PackedW":
        return self._replace(codes=self.codes.to(device),
                             meta=self.meta.to(device))

    def layer(self, i: int) -> "PackedW":
        """The per-layer slice of a stacked weight (views, no copy)."""
        return self._replace(codes=self.codes[i], meta=self.meta[i])

    def to_kernel_layout(self) -> "PackedW":
        """One-time re-layout artifact -> K-major kernel buffers (same bits,
        contiguous). Accepts 2-D and stacked-layer weights."""
        if self.kernel_layout:
            return self
        k, n = self.shape2d
        lead = tuple(self.codes.shape[:-3])
        codes = self.codes.reshape(lead + (n, k // 2)).transpose(-1, -2)
        meta = self.meta.transpose(-1, -2)
        return self._replace(codes=codes.contiguous(), meta=meta.contiguous(),
                             kernel_layout=True)

    def kernel_operands(self):
        """(codes_km (K/2, N) uint8, meta_km (K/64, N) int32) for the fused
        matmul; artifact-layout weights re-layout per call."""
        kw = self.to_kernel_layout()
        if kw.codes.ndim != 2:
            raise ValueError(
                f"kernel_operands needs a per-layer slice, got codes "
                f"{tuple(kw.codes.shape)}")
        return kw.codes, kw.meta

    def reshape(self, *shape):
        """Validate-and-pass-through: the models' ``w.reshape(d, -1)`` call
        sites must resolve to exactly the packed layout (K, N)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        k, n = self.shape2d
        if len(shape) != 2 or sum(1 for s in shape if s == -1) > 1:
            raise ValueError(f"PackedW.reshape{shape}: packed layout is 2-D")
        known = math.prod(s for s in shape if s != -1)
        resolved = tuple(s if s != -1 else (k * n) // known for s in shape)
        if resolved != (k, n):
            raise ValueError(f"PackedW.reshape{shape} resolved to {resolved}, "
                             f"but the packed layout is (K, N) = {self.shape2d}")
        return self

    @property
    def ndim(self):
        return 2

    @classmethod
    def from_dense(cls, w: torch.Tensor, contract_axes=(0,)) -> "PackedW":
        """Quantize + pack a dense weight (offline PTQ), in slabs of output
        columns of at most ``PACK_SLAB_VALUES`` values (at least one column
        each): Algorithm 1's float32 temporaries are a slab's size, not the
        weight's. Grouping runs along K within a column, so the result is
        bitwise a one-shot pack."""
        nd = w.ndim
        contract_axes = tuple(a % nd for a in contract_axes)
        out_axes = tuple(a for a in range(nd) if a not in contract_axes)
        k = math.prod(w.shape[a] for a in contract_axes)
        n = math.prod(w.shape[a] for a in out_axes) if out_axes else 1
        if k % hif4.GROUP_SIZE:
            raise ValueError(f"K={k} of {tuple(w.shape)} is not a multiple of 64")
        groups = w.permute(out_axes + contract_axes).reshape(
            n, k // hif4.GROUP_SIZE, hif4.GROUP_SIZE)
        cols = max(1, PACK_SLAB_VALUES // k)
        slabs = [hif4.pack_groups(hif4.quantize_groups(
            groups[c:c + cols].to(torch.float32))) for c in range(0, n, cols)]
        if len(slabs) == 1:
            return cls(slabs[0].codes, slabs[0].meta, (k, n), w.dtype)
        return cls(torch.cat([p.codes for p in slabs]),
                   torch.cat([p.meta for p in slabs]), (k, n), w.dtype)

    def dequantize(self) -> torch.Tensor:
        """Expand to the (K, N) dense weight."""
        k, n = self.shape2d
        if self.kernel_layout:
            return hif4.dequantize_km(*self.kernel_operands(), dtype=self.dtype)
        vals = hif4.dequantize_groups(
            hif4.unpack_groups(hif4.HiF4Packed(self.codes, self.meta)))
        return vals.reshape(n, k).T.to(self.dtype)

    @property
    def nbytes_packed(self) -> int:
        """Bytes of 4.5-bit payload actually resident (codes + meta)."""
        return self.codes.numel() + 4 * self.meta.numel()

    @property
    def n_values(self) -> int:
        return self.codes.numel() * 2
