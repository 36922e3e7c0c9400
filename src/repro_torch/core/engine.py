"""Execution engine: the single dispatch point for quantized matmuls and
packed-KV decode attention (port of ``repro/core/engine.py``).

``QuantConfig.impl`` selects how a quantized contraction executes:

  qdq    — fake-quant the operands, matmul in bf16/f32.
  packed — the weight is a resident :class:`PackedW` (0.5625 B/value) and is
           contracted by the fused packed matmul: activations are quantized
           by ``hif4_quantize`` and the kernel expands the 4.5-bit payload
           in shared memory. On CUDA tensors with at most ``DECODE_M_MAX``
           rows (decode) one launch does both (``fused_decode_matmul``,
           kernel 1 as the prologue of kernel 2's decode form) wherever
           ``decode_plan`` fits its K range in shared memory; with more
           rows, or a longer K, the two CUDA kernels launch. On CPU
           tensors their plain versions run, with the reference's off-TPU
           size cap (above it: dequantize-then-dot).
  pallas — on a PackedW the same fused path as ``packed``; on a dense weight
           both operands are quantized by Algorithm 1 on every call and
           contracted by the fixed-point kernel (``kernels.ops.matmul``): on
           CUDA tensors with at most ``DECODE_M_MAX`` rows (the LM head at
           decode) kernel 1 on the activations, then the decode form of
           kernel 5 (``bfp_decode_matmul``), which quantizes the weight in
           its loader; with more rows kernel 1 on both operands, then kernel
           5. On CPU tensors their plain versions run.

Dispatch is total, following the reference's fallback table:

  * non-HiF4 formats on ``pallas``          -> qdq
  * ``weights_only`` on ``pallas``          -> qdq
  * dense (unpacked) weight under ``packed``-> qdq
  * PackedW under ``qdq``                   -> dequantize-then-dot
  * PackedW x ``weights_only`` / non-HiF4
    fmt / non-innermost contraction         -> dequantize-then-dot
  * contraction not a whole number of
    64-groups                               -> qdq

Decode attention over an HiF4-packed KV cache dispatches here too
(:func:`attention_decode`): impl packed/pallas on a kernel-tileable cache
takes the fused decode-attention kernel, contiguous or paged (its plain
version on CPU tensors); every other combination runs the plain recurrence.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import hif4, kvcache
from repro_torch.core import tap as site_tap
from repro_torch.core.qlinear import (
    NO_QUANT,
    PackedW,
    QuantConfig,
    quantize_activation,
    quantize_weight,
)
from repro_torch.kernels.fused_attention import (
    fused_decode_attention,
    fused_decode_attention_plain,
    fused_paged_decode_attention,
    fused_paged_decode_attention_plain,
    kernel_compatible,
    select_kv_block,
)
from repro_torch.kernels import ops
from repro_torch.kernels.bfp_matmul import (
    DECODE_M_MAX,
    cuda_tiles,
    decode_matmul_plan,
    select_block_sizes,
)
from repro_torch.kernels.fused_matmul import (
    decode_plan,
    fused_decode_matmul,
    fused_packed_matmul,
)
from repro_torch.kernels.hif4_quant import hif4_quantize


@dataclasses.dataclass(frozen=True)
class EngineCtx:
    """Everything a quantized contraction needs besides its operands."""

    quant: QuantConfig = NO_QUANT


DEFAULT_ENGINE = EngineCtx()


def dot(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    """x (..., K) @ w (K, N) with the output in ``out_dtype``. A float32
    output from bf16 operands accumulates in float32 without an f32 copy of
    ``w`` on CUDA (``torch.mm`` with ``out_dtype``; on ``meta`` too, where
    the dry run costs the card's route); the CPU upcasts, and so does CUDA
    where autograd records the product (``torch.mm`` with ``out_dtype`` has
    no derivative)."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if out_dtype == torch.float32 and x.dtype != torch.float32:
        recorded = torch.is_grad_enabled() and (x.requires_grad
                                                or w.requires_grad)
        if x.device.type in ("cuda", "meta") and not recorded:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            y = x2.to(torch.float32) @ w.to(torch.float32)
    else:
        y = (x2 @ w.to(x2.dtype)).to(out_dtype)
    return y.reshape(lead + (w.shape[1],))


def matmul(x: torch.Tensor, w, ectx: EngineCtx = DEFAULT_ENGINE, *,
           contract_x: int = -1, contract_w: int = 0,
           accum_dtype=None) -> torch.Tensor:
    """``x @ w`` through the configured execution path. ``w`` is a dense
    tensor or a :class:`PackedW`; ``accum_dtype`` is the dot output dtype on
    the qdq/fallback paths (default x.dtype)."""
    cfg = ectx.quant
    # calibration probe: record this contraction's activation operand under
    # the site path ModelCtx.site_quant marked (no-op without an installed
    # tap, see repro_torch.core.tap)
    site_tap.consume_pending(x, contract_x)
    if isinstance(w, PackedW):
        if _fused_packed_ok(cfg, x, contract_x, w):
            return _fused_packed_matmul(x, w, ectx)
        return _packed_matmul(x, w, ectx, contract_x=contract_x,
                              accum_dtype=accum_dtype)
    if (cfg.enabled and cfg.impl == "pallas"
            and _pallas_activation_ok(cfg, x, contract_x)
            and _pallas_weight_ok(w, contract_w)):
        return _pallas_dense_matmul(x, w)
    return _qdq_matmul(x, w, cfg, contract_x=contract_x, contract_w=contract_w,
                       accum_dtype=accum_dtype)


def qdq_einsum(eq: str, a: torch.Tensor, w: torch.Tensor, ectx: EngineCtx, *,
               a_axis: int = -1, w_axis: int = 1) -> torch.Tensor:
    """Batched-contraction einsum (the MoE expert matmuls) on the qdq path:
    both operands fake-quantized along their contraction axes, then a plain
    einsum. Batched-expert weights have no packed or kernel route, whatever
    ``impl`` says (the (E, C) dispatch buffer re-tiles per step, so there is
    no static packed operand to contract against)."""
    cfg = ectx.quant
    site_tap.consume_pending(a, a_axis)
    if cfg.enabled:
        a = quantize_activation(a, cfg, axis=a_axis)
        w = quantize_weight(w, cfg, axis=w_axis)
    return torch.einsum(eq, a, w)


def in_row_chunks(fn, x: torch.Tensor, rows: int, axis: int = 0
                  ) -> torch.Tensor:
    """``fn`` on chunks of exactly ``rows`` indices of ``x``'s ``axis`` (the
    last one zero-padded, each chunk contiguous), concatenated along the
    same axis of the results and cut back to ``x``'s length. Every call
    has one shape, so a row's result does not depend on the rows beside it:
    a GEMM's algorithm, and with it the order of its sums, may change with
    its row count."""
    n = x.shape[axis]
    pad = list(x.shape)
    pad[axis] = -n % rows
    x = torch.cat([x, x.new_zeros(pad)], dim=axis)
    out = torch.cat([fn(c.contiguous()) for c in x.split(rows, dim=axis)],
                    dim=axis)
    return out.narrow(axis, 0, n)


# ---------------------------------------------------------------------------
# qdq path
# ---------------------------------------------------------------------------


def _qdq_matmul(x, w, cfg, *, contract_x, contract_w, accum_dtype):
    out_dtype = x.dtype
    if cfg.enabled:
        x = quantize_activation(x, cfg, axis=contract_x)
        w = quantize_weight(w, cfg, axis=contract_w)
    x = torch.movedim(x, contract_x, -1)
    w2 = torch.movedim(w, contract_w, 0)
    w2 = w2.reshape(w2.shape[0], -1)
    y = dot(x, w2, accum_dtype or out_dtype)
    y = y.reshape(x.shape[:-1] + tuple(torch.movedim(w, contract_w, 0).shape[1:]))
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# fused packed path
# ---------------------------------------------------------------------------


def _fused_packed_ok(cfg: QuantConfig, x, contract_x: int, w: PackedW) -> bool:
    """The fused kernel quantizes activations and tiles K: it needs a
    packed/pallas impl on HiF4, both-operand quantization and an innermost
    contraction of exactly K."""
    return (
        cfg.impl in ("packed", "pallas")
        and cfg.fmt == "hif4"
        and not cfg.weights_only
        and contract_x % x.ndim == x.ndim - 1
        and x.shape[-1] == w.shape2d[0]
    )


# The reference's off-TPU cap: its XLA twin's group-batched dot materializes
# a (K/64, M, N) f32 intermediate, and above this size it takes the
# dequantize fallback. The CPU here takes the same route at the same sizes.
_PLAIN_FUSED_PART_BYTES_MAX = 128 * 2 ** 20


def _fused_packed_matmul(x, w: PackedW, ectx: EngineCtx):
    """Serving hot path: dynamic activation quant x packed resident weight,
    dequantized inside the contraction."""
    out_dtype = x.dtype
    k, n = w.shape2d
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x2.is_cuda:
        part_bytes = (k // hif4.GROUP_SIZE) * x2.shape[0] * n * 4
        if part_bytes > _PLAIN_FUSED_PART_BYTES_MAX:
            return _packed_matmul(x, w, ectx, contract_x=-1, accum_dtype=None)
    codes_km, meta_km = w.kernel_operands()
    m = x2.shape[0]
    if x2.is_cuda and m <= DECODE_M_MAX and decode_plan(m, k, n).one_launch:
        y = fused_decode_matmul(x2.contiguous(), codes_km, meta_km, out_dtype)
        return y.reshape(lead + (n,))
    # prefill, or a decode linear whose K range the decode form cannot hold
    # (its plan's two launches): kernel 1, then kernel 2
    ai, asc = hif4_quantize(x2.contiguous())
    # the kernel writes bf16 or f32 itself (bitwise the cast of its f32 sum)
    kernel_dtype = out_dtype if out_dtype == torch.bfloat16 else torch.float32
    y = fused_packed_matmul(ai, asc, codes_km, meta_km, kernel_dtype)
    return y.reshape(lead + (n,)).to(out_dtype)


def packed_dispatch_info(quant: QuantConfig, w: PackedW, *, decode_m: int,
                         prefill_m: int, device) -> dict:
    """What the engine will run for ``w`` under ``quant`` on ``device`` — the
    launcher prints it next to the residency lines. ``*_blocks`` are the
    reference's per-regime tiles. ``*_kernel`` names the CUDA kernel each
    regime launches and what its ``*_tiles`` tuple holds: the decode form's
    launch plan (rows, column tile, CTAs splitting K) for at most
    ``DECODE_M_MAX`` rows, else the prefill form's plan (BM, BN, ring stages
    of one 64-group; ``bfp_matmul.prefill_plan``)."""
    k, n = w.shape2d
    probe = torch.empty((decode_m, k), dtype=torch.bfloat16, device="meta")
    none = {"decode_blocks": None, "prefill_blocks": None,
            "decode_kernel": None, "decode_tiles": None,
            "prefill_kernel": None, "prefill_tiles": None}
    if not _fused_packed_ok(quant, probe, -1, w):
        return {"fused": False, "execution": "dequantize-then-dot fallback", **none}
    if torch.device(device).type != "cuda":
        return {"fused": True,
                "execution": "plain PyTorch fused contraction (CPU)", **none}
    decode_kernel, decode_tiles = _cuda_plan(decode_m, k, n)
    prefill_kernel, prefill_tiles = _cuda_plan(prefill_m, k, n)
    return {"fused": True, "execution": "CUDA fused kernel",
            "decode_blocks": select_block_sizes(decode_m, n, k),
            "prefill_blocks": select_block_sizes(prefill_m, n, k),
            "decode_kernel": decode_kernel, "decode_tiles": decode_tiles,
            "prefill_kernel": prefill_kernel, "prefill_tiles": prefill_tiles}


def _cuda_plan(m: int, k: int, n: int) -> tuple:
    """(the kernel :func:`_fused_packed_matmul` launches for ``m`` rows on
    CUDA tensors, with what its tiles tuple holds; the tiles)."""
    if m <= DECODE_M_MAX:
        plan = decode_plan(m, k, n)
        if plan.one_launch:
            return ("fused_decode_matmul (M, BN, K split)",
                    (m, plan.tile_n, plan.split))
        return ("hif4_quantize, then fused_packed_matmul (BM, BN, groups per "
                "step)", cuda_tiles(m))
    return "fused_packed_matmul (BM, BN, stages)", cuda_tiles(m)


# ---------------------------------------------------------------------------
# fused decode-attention path
# ---------------------------------------------------------------------------


def _fused_attn_ok(cfg: QuantConfig, k_cache: dict, n_kv_heads: int,
                   d_head: int) -> bool:
    return (cfg.impl in ("packed", "pallas")
            and kernel_compatible(k_cache, n_kv_heads, d_head))


def attention_decode(q, k_cache: dict, v_cache: dict, length,
                     n_kv_heads: int, d_head: int,
                     ectx: EngineCtx = DEFAULT_ENGINE, *,
                     pages: Optional[torch.Tensor] = None,
                     block_kv: Optional[int] = None) -> torch.Tensor:
    """Decode attention against a PACKED KV cache: the fused kernel for impl
    packed/pallas on a kernel-tileable cache, the plain recurrence otherwise.

    With ``pages`` (B, max_pages) the caches are per-layer page-POOL leaves
    (NP, F, P) and the same dispatch picks the paged kernel / paged plain
    version. ``block_kv`` overrides the contiguous KV tile (the paged tile
    IS the page size); serving threads it from ``ModelCtx.attn_kv_block`` so
    a solo reference run can tile its cache like a paged run, bitwise."""
    fused = _fused_attn_ok(ectx.quant, k_cache, n_kv_heads, d_head)
    if pages is not None:
        if fused:
            return fused_paged_decode_attention(
                q, k_cache, v_cache, pages, length, n_kv_heads=n_kv_heads,
                d_head=d_head)
        return fused_paged_decode_attention_plain(
            q, k_cache, v_cache, pages, length, n_kv_heads, d_head)
    if fused:
        return fused_decode_attention(q, k_cache, v_cache, length,
                                      n_kv_heads=n_kv_heads, d_head=d_head,
                                      block_kv=block_kv)
    return fused_decode_attention_plain(q, k_cache, v_cache, length,
                                        n_kv_heads, d_head, block_kv=block_kv)


def attention_dispatch_info(quant: QuantConfig, k_cache: dict, *,
                            n_kv_heads: int, d_head: int, device,
                            paged: bool = False) -> dict:
    """What :func:`attention_decode` will run for this cache under ``quant``
    on ``device``: ``fused`` (the CUDA kernel), ``execution``, ``block_kv``,
    ``kernel_eligible`` (device-neutral) and ``route``. ``paged=True``
    answers for page-pool leaves (``pages`` passed to
    :func:`attention_decode`)."""
    block = (kvcache.pool_page_tokens(k_cache) if paged
             else select_kv_block(kvcache.seq_capacity(k_cache)))
    route = "fused_paged_decode_attention" if paged else "fused_decode_attention"
    eligible = _fused_attn_ok(quant, k_cache, n_kv_heads, d_head)
    if not eligible:
        if quant.impl not in ("packed", "pallas"):
            why = f"impl={quant.impl}"
        elif not kvcache.is_kernel_layout(k_cache):
            why = "artifact layout"
        else:
            why = "staging tail"
        return {"fused": False, "block_kv": block, "kernel_eligible": False,
                "route": route + "_plain",
                "execution": f"plain recurrence (chunked dequantize; {why})"}
    if torch.device(device).type != "cuda":
        return {"fused": False, "block_kv": block, "kernel_eligible": True,
                "route": route, "execution": "plain recurrence (CPU)"}
    execution = ("CUDA fused kernel" if d_head % 2 == 0
                 else "CUDA fused kernel (refuses an odd d_head: raises)")
    return {"fused": True, "block_kv": block, "kernel_eligible": True,
            "route": route, "execution": execution}


# ---------------------------------------------------------------------------
# packed fallback: dequantize the PackedW, then a dense dot
# ---------------------------------------------------------------------------


def _packed_matmul(x, w: PackedW, ectx: EngineCtx, *, contract_x, accum_dtype):
    out_dtype = x.dtype
    wd = w.dequantize()                                  # (K, N) dense
    x = quantize_activation(x, ectx.quant, axis=contract_x)
    x = torch.movedim(x, contract_x, -1)
    return dot(x, wd, accum_dtype or out_dtype).to(out_dtype)


# ---------------------------------------------------------------------------
# pallas path: Algorithm-1 quantize kernel + §III.B fixed-point matmul
# ---------------------------------------------------------------------------


def _pallas_activation_ok(cfg: QuantConfig, x, contract_x: int) -> bool:
    return (cfg.fmt == "hif4" and not cfg.weights_only
            and contract_x % x.ndim == x.ndim - 1
            and x.shape[-1] % hif4.GROUP_SIZE == 0)


def _pallas_weight_ok(w, contract_w: int) -> bool:
    return (w.ndim == 2 and contract_w % w.ndim == 0
            and w.shape[0] % hif4.GROUP_SIZE == 0)


def _pallas_dense_matmul(x, w):
    """Both operands quantized by Algorithm 1 on every call (A-W dynamic
    quantization), contracted by the fixed-point kernel (the route by rows:
    :func:`dense_dispatch_info`). The f32 result is cast to ``x.dtype``, as
    the reference casts it: a bf16 ``x`` (the LM head's) rounds its logits
    to bf16 here."""
    lead, k = x.shape[:-1], x.shape[-1]
    y = ops.matmul(x.reshape(-1, k), w)
    return y.reshape(lead + (w.shape[1],)).to(x.dtype)


def dense_dispatch_info(quant: QuantConfig, k: int, n: int, *, m: int,
                        device) -> dict:
    """What the engine runs for ``m`` rows against a dense (K, N) weight
    under ``quant`` (the LM head under a policy that quantizes it) on
    ``device``: the launcher prints it next to the packed matmul line.
    ``route`` names the launches of the call, ``plan`` the CUDA plan of its
    contraction (``bfp_matmul.decode_matmul_plan``'s rows, stages, CTAs per
    SM and grid for the decode form; the tensor-core body's (BM, BN,
    stages) above ``DECODE_M_MAX`` rows)."""
    probe = torch.empty((m, k), dtype=torch.bfloat16, device="meta")
    if not (quant.enabled and quant.impl == "pallas"
            and _pallas_activation_ok(quant, probe, -1)):
        return {"pallas": False, "execution": "qdq", "route": None,
                "plan": None}
    if torch.device(device).type != "cuda":
        return {"pallas": True, "route": None, "plan": None,
                "execution": "plain PyTorch fixed-point contraction (CPU)"}
    if m <= DECODE_M_MAX:
        plan = decode_matmul_plan(m, k, n, "bf16")
        return {"pallas": True, "execution": "CUDA fixed-point kernels",
                "route": "hif4_quantize on x, then bfp_decode_matmul (kernel "
                         "5's decode form, the weight quantized in its loader)",
                "plan": (plan.rows, plan.stages, plan.ctas_per_sm, plan.grid)}
    return {"pallas": True, "execution": "CUDA fixed-point kernels",
            "route": "hif4_quantize on x and on w.T, then bfp_matmul_quantized "
                     "(int8 tensor-core body)", "plan": cuda_tiles(m)}


def packed_to_absorbed(w: PackedW) -> tuple[torch.Tensor, torch.Tensor]:
    """PackedW -> (ints (K, N) int8, scales (K/64, N) f32): the absorbed-shift
    integers of §III.B that kernel 2 expands per tile, materialized (kernel
    5 on them is bitwise kernel 2 on ``w``)."""
    return hif4.absorbed_int_km(*w.kernel_operands())
