"""Shared model building blocks: per-site quantization context, norms, RoPE,
the quantized dense helper and the cross-entropy loss (port of
``repro/models/common.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core import tap as site_tap
from repro_torch.core.policy import QuantPlan, uniform_site_config
from repro_torch.core.qlinear import NO_QUANT, QuantConfig


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Everything a model forward needs besides params and inputs.

    Quantization placement is PER SITE: every linear call site asks
    :meth:`site_quant` for its config — from the resolved ``plan`` when one
    is attached, else from the uniform shim over the global ``quant``.
    ``scope`` is the param-tree prefix the current block runs under.
    ``remat``: recompute each layer's activations in the backward
    (``torch.utils.checkpoint``) instead of keeping them; it engages only
    where autograd records the forward (see ``repro_torch.models.lm``).
    """

    quant: QuantConfig = NO_QUANT
    plan: Optional[QuantPlan] = None
    scope: str = ""
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024
    # "scan_q": the q-chunk loop with its causal early exit (default);
    # "vec_q": every q chunk advances together (attention.flash_mha_vec)
    attn_impl: str = "scan_q"
    # Decode KV-tile override for the packed attention paths (None = the
    # kernel's own select_kv_block). Bitwise parity between a paged run
    # (tiles = pages) and a contiguous reference depends on the PARTITION
    # of tokens into tiles, so solo references set this to the page size.
    attn_kv_block: Optional[int] = None

    def __post_init__(self):
        # a plan-carrying ctx left at the default quant derives it from the
        # plan's attention-site config (KV format and attention dispatch)
        if self.plan is not None and self.quant == NO_QUANT:
            object.__setattr__(self, "quant", self.plan.base)

    def scoped(self, prefix: str) -> "ModelCtx":
        return dataclasses.replace(self, scope=prefix)

    def site_quant(self, site: str) -> QuantConfig:
        """The QuantConfig the linear layer at ``site`` (relative to
        :attr:`scope`, e.g. "attn.wq") executes under."""
        path = f"{self.scope}.{site}" if self.scope else site
        # calibration probe: mark the activation tap with the site path the
        # next engine contraction executes under (no-op without a tap, see
        # repro_torch.core.tap)
        site_tap.mark_site(path)
        if self.plan is not None:
            return self.plan.at(path)
        return uniform_site_config(self.quant, path)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """Computed in f32, cast back."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32 (the mean, then the mean squared deviation, as
    ``jnp.var``), cast back."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                         # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs        # (.., seq, d/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense(x: torch.Tensor, w, *, quant: QuantConfig = NO_QUANT,
          accum_dtype=None) -> torch.Tensor:
    """y = x @ w, executed by the engine path ``quant.impl`` selects; ``w`` is
    (d_in, ...) dense or a :class:`PackedW`."""
    return engine.matmul(x, w, engine.EngineCtx(quant=quant), contract_x=-1,
                         contract_w=0, accum_dtype=accum_dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over tokens; logits (..., V) upcast to f32, labels (...)
    integer; with ``mask``, the mask-weighted mean."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
