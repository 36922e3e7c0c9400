"""Mixture-of-Experts FFN: top-k token-choice routing and capacity dispatch
(port of ``repro/models/moe.py``).

GShard-style dispatch: each batch element is one dispatch group, and it
dispatches into an (experts, capacity) buffer (the reference's one-hot
einsums; here a scatter and a gather by the same positions). Tokens
beyond an expert's capacity within their group are dropped. The
router runs on its own policy site ("moe.router", excluded from
quantization by the default rules) and its softmax in float32; the expert
matmuls are batched einsums fake-quantized along their contraction axes
under their own sites ("moe.wg", "moe.wu", "moe.wi", "moe.wo"). They have no
packed or kernel route (:func:`repro_torch.core.engine.qdq_einsum`). The
port has one device, so the reference's sharding constraints have no
counterpart here.

On the card a token's result must not depend on the tokens beside it: a
request's tokens are the same served alone or in a batch, and a shared
prompt prefix has the same K/V bytes whatever follows it (the paged pool
shares its pages only then). But a GEMM's algorithm, and with it the order
of its sums, may change with its row count, and a one-hot GEMM over the
(experts, capacity) buffer sums a token's choices in an order set by its
buffer positions, which depend on the whole group. So the router and the
expert matmuls run on row chunks of one fixed shape
(:func:`repro_torch.core.engine.in_row_chunks`), tokens are scattered into
the expert buffer and gathered back by their positions (the reference's
dispatch einsum has one nonzero term per sum: exact), and each token's
gate-weighted expert outputs are summed in float32 in expert order, as a
dot over the (experts, capacity) axis sums them, then rounded to bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine
from repro_torch.core import tap as site_tap
from repro_torch.core.spans import span
from repro_torch.models.common import ModelCtx, dense
from repro_torch.models.params import PSpec

# rows of every router and expert product: each runs on a zero-padded chunk
# of exactly this many rows (a decode step of 8 requests gives granite's
# experts 8 x 4 buffer rows each)
ROW_CHUNK = 32


def moe_specs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d, fe, E = cfg.d_model, m.d_expert, m.n_experts
    specs = {
        # router in f32: small, excluded from quantization, numerically touchy
        "router": PSpec((d, E), ("fsdp", None), dtype=torch.float32),
    }
    if cfg.activation == "swiglu":
        specs["wg"] = PSpec((E, d, fe), ("experts", "fsdp", None))
        specs["wu"] = PSpec((E, d, fe), ("experts", "fsdp", None))
    else:
        specs["wi"] = PSpec((E, d, fe), ("experts", "fsdp", None))
    specs["wo"] = PSpec((E, fe, d), ("experts", None, "fsdp"))
    return specs


def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    c = math.ceil(tokens_per_group * m.top_k * m.capacity_factor / m.n_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4, floor 4


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last axis, ties to
    the lower index (``jax.lax.top_k``'s order; ``torch.topk`` makes no
    promise on ties, and bf16 router logits tie often)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _positions(idx: torch.Tensor, E: int) -> torch.Tensor:
    """(B, S, k) int64: each choice's position in its expert's buffer, the
    count of the group's earlier choices of that expert in slot-major order
    (every token's first choice counts before any second one)."""
    B, S, k = idx.shape
    mask = F.one_hot(idx, E).to(torch.int32)                        # (B,S,k,E)
    order = mask.transpose(1, 2).reshape(B, k * S, E)
    pos = torch.cumsum(order, dim=1, dtype=torch.int32) - order
    pos = pos.reshape(B, k, S, E).transpose(1, 2)
    return torch.gather(pos, 3, idx[..., None])[..., 0].long()


def _dispatch_combine(idx: torch.Tensor, gates: torch.Tensor, E: int, C: int):
    """The reference's (B, S, E, C) combine tensor (gate-weighted one-hots)
    and boolean dispatch mask, from the positions :func:`moe_apply`
    scatters and gathers by.

    idx (B, S, k) integer, the chosen experts; gates (B, S, k) f32. Tokens
    at position C or beyond are dropped. Each (token, expert) is chosen
    once, so every kept gate lands on a slot of its own (the reference's
    sum of one-hots, exactly); a dropped one writes +0 at its own token's
    last slot, as the sum leaves it."""
    B, S, k = idx.shape
    idx = idx.long()
    pos = _positions(idx, E)
    s = torch.arange(B * S, device=idx.device).reshape(B, S, 1)
    flat = (s * E + idx) * C + torch.clamp(pos, max=C - 1)
    combine = torch.zeros(B * S * E * C, dtype=torch.float32, device=idx.device)
    combine[flat.reshape(-1)] = (gates * (pos < C)).reshape(-1)
    combine = combine.reshape(B, S, E, C)
    return combine, combine > 0.0


def route(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx):
    """x (B, S, d) -> (gates (B, S, k) f32, renormalized; idx (B, S, k) the
    chosen experts): the router's bf16 logits, their softmax in f32, top-k."""
    B, S, d = x.shape
    rq = ctx.site_quant("moe.router")
    # the activation tap sees one record per call, the reference's rows
    site_tap.consume_pending(x, -1)
    logits = engine.in_row_chunks(lambda c: dense(c, p["router"], quant=rq),
                                  x.reshape(B * S, d), ROW_CHUNK)
    probs = torch.softmax(logits.to(torch.float32).reshape(B, S, -1), dim=-1)
    gates, idx = top_k(probs, cfg.moe.top_k)
    return gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9), idx


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx
              ) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d). Each batch element is one dispatch group."""
    B, S, d = x.shape
    E, C = cfg.moe.n_experts, capacity(cfg, S)
    gates, idx = route(p, x, cfg, ctx)
    idx = idx.long()
    pos = _positions(idx, E)
    # every kept (token, expert) has a buffer row of its own, expert-major:
    # (E, B * C) rows; a dropped one goes to a sink row past the end
    b = torch.arange(B, device=x.device).reshape(B, 1, 1)
    row = torch.where(pos < C, (idx * B + b) * C + pos, E * B * C)
    k = idx.shape[-1]
    xe = x.new_zeros((E * B * C + 1, d))
    xe[row.reshape(-1)] = x[:, :, None].expand(B, S, k, d).reshape(-1, d)
    xe = xe[:-1].reshape(E, B * C, d)

    def qbmm(a, w, site):
        """Batched-expert einsum, quantized along the contraction, on chunks
        of ``ROW_CHUNK`` buffer rows (the activations quantize per row, and
        a served tree's expert weights were quantized offline)."""
        ectx = engine.EngineCtx(quant=ctx.site_quant(site))
        # one tap record of the whole buffer, in the reference's (batch,
        # expert, capacity) row order, before the chunks
        site_tap.consume_pending(a.reshape(E, B, C, -1).transpose(0, 1), -1)
        return engine.in_row_chunks(
            lambda c: engine.qdq_einsum("erd,edf->erf", c, w, ectx, a_axis=-1,
                                        w_axis=1), a, ROW_CHUNK, 1)

    with span("moe.experts"):
        if cfg.activation == "swiglu":
            h = F.silu(qbmm(xe, p["wg"], "moe.wg").to(torch.float32))
            h = (h * qbmm(xe, p["wu"], "moe.wu").to(torch.float32)).to(x.dtype)
        else:
            # jax.nn.gelu's default is the tanh approximation
            h = F.gelu(qbmm(xe, p["wi"], "moe.wi").to(torch.float32),
                       approximate="tanh").to(x.dtype)
        ye = qbmm(h, p["wo"], "moe.wo").reshape(E * B * C, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])                  # the sink: 0

    # combine: each token's choices in expert order, gate (rounded to the
    # outputs' bf16, as the reference casts its combine tensor) times output,
    # summed in f32 from +0
    order = torch.argsort(idx, dim=-1)
    row = torch.gather(row, -1, order)
    g = torch.gather(gates, -1, order).to(ye.dtype).to(torch.float32)
    y = torch.zeros((B, S, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + g[..., j, None] * ye[row[..., j]].to(torch.float32)
    return y.to(x.dtype)


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-Transformer load-balancing auxiliary loss (for training): E
    times the dot of the mean router probability per expert and the share
    of tokens whose first choice it is. ``logits`` (..., E) the router's,
    ``idx`` (..., k) the chosen experts. Not part of ``train_loss``, as in
    the reference."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = torch.mean(probs.reshape(-1, n_experts), dim=0)
    ce = torch.mean(F.one_hot(idx[..., 0].reshape(-1).long(), n_experts)
                    .to(torch.float32), dim=0)
    return n_experts * torch.sum(me * ce)
