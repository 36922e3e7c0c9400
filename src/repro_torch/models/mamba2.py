"""Mamba2 block: SSD (state-space duality) chunked scan + recurrent decode
(port of ``repro/models/mamba2.py``).

Follows arXiv:2405.21060. The selective SSM recurrence
    h_t = exp(dt_t * A) h_{t-1} + dt_t B_t x_t,   y_t = C_t . h_t + D x_t
is evaluated in chunks: an intra-chunk quadratic ("attention-like") term and
an inter-chunk state recurrence (a loop over chunks). HiF4 applies to the
six in/out projections (``dense`` with their per-site configs); the SSD scan
and the causal conv stay in high precision, plain PyTorch, as the reference
runs them in XLA (no Pallas kernel).

Orders and dtypes follow the reference op for op: ``conv_full`` multiplies
and sums in bf16 term by term, ``conv_step`` in f32; ``softplus`` is
``logaddexp(x, 0)`` (no threshold); each three-operand einsum is written as
the reference's two pairwise products, in its order, in f32. A matmul sums
in another order than XLA's dot, so the scan is f32-close to the
reference, not bitwise. Decode updates the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.spans import span
from repro_torch.models.common import ModelCtx, dense, rms_norm
from repro_torch.models.params import PSpec


def dims(cfg: ArchConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H = di // s.head_dim
    return di, H, s.n_groups, s.d_state, s.head_dim, s.conv_kernel


def mamba_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di, H, G, N, P, K = dims(cfg)
    return {
        "pre_norm": PSpec((d,), (None,), init="ones"),
        "w_z": PSpec((d, di), ("fsdp", "ssm_inner")),
        "w_x": PSpec((d, di), ("fsdp", "ssm_inner")),
        "w_b": PSpec((d, G * N), ("fsdp", None)),
        "w_c": PSpec((d, G * N), ("fsdp", None)),
        "w_dt": PSpec((d, H), ("fsdp", "heads")),
        "conv_w_x": PSpec((K, di), (None, "ssm_inner"), std=0.2),
        "conv_b_x": PSpec((di,), ("ssm_inner",), init="zeros"),
        "conv_w_bc": PSpec((K, 2 * G * N), (None, None), std=0.2),
        "conv_b_bc": PSpec((2 * G * N,), (None,), init="zeros"),
        "a_log": PSpec((H,), ("heads",), dtype=torch.float32, init="zeros"),
        "dt_bias": PSpec((H,), ("heads",), dtype=torch.float32, init="zeros"),
        "d_skip": PSpec((H,), ("heads",), dtype=torch.float32, init="ones"),
        "gate_norm": PSpec((di,), ("ssm_inner",), init="ones"),
        "w_out": PSpec((di, d), ("ssm_inner", "fsdp")),
    }


def mamba_cache_specs(cfg: ArchConfig, batch: int) -> dict:
    di, H, G, N, P, K = dims(cfg)
    return {
        "conv_x": PSpec((batch, K - 1, di), ("batch", None, "ssm_inner"),
                        dtype=torch.bfloat16, init="zeros"),
        "conv_bc": PSpec((batch, K - 1, 2 * G * N), ("batch", None, None),
                         dtype=torch.bfloat16, init="zeros"),
        "ssd": PSpec((batch, H, P, N), ("batch", "heads", None, None),
                     dtype=torch.float32, init="zeros"),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Causal depthwise conv1d
# ---------------------------------------------------------------------------


def conv_full(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (K, C): causal depthwise conv, returns (B, S, C). Each
    product and each partial sum is rounded to x's dtype, k = 0 .. K-1."""
    K = w.shape[0]
    S = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for k in range(1, K):
        y = y + xp[:, k:k + S] * w[k].to(x.dtype)
    return silu((y + b.to(x.dtype)).to(torch.float32)).to(x.dtype)


def conv_step(x1: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """x1 (B, C) one step, state (B, K-1, C) the past inputs: returns y1 and
    shifts ``x1`` into ``state`` in place. Products and sums in f32."""
    K = w.shape[0]
    wf = w.to(torch.float32)
    y = state[:, 0].to(torch.float32) * wf[0]
    for k in range(1, K - 1):
        y = y + state[:, k].to(torch.float32) * wf[k]
    y = y + x1.to(torch.float32) * wf[K - 1]
    y = silu(y + b.to(torch.float32))
    state[:, :-1] = state[:, 1:].clone()
    state[:, -1] = x1.to(state.dtype)
    return y.to(x1.dtype)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bv: torch.Tensor, cv: torch.Tensor, d_skip: torch.Tensor,
             chunk: int, init_state=None):
    """Chunked SSD: xh (B, S, H, P) bf16, dt (B, S, H) f32 (softplus'd), a
    (H,) f32 negative, bv / cv (B, S, N) f32 (one group), d_skip (H,) f32,
    init_state (B, H, P, N) f32 or None. Returns (y (B, S, H, P),
    final_state (B, H, P, N) f32). The prompt must be a multiple of the
    chunk (once the chunk is cut to the prompt)."""
    B, S, H, P = xh.shape
    N = bv.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by ssd chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32

    x_ = xh.reshape(B, nc, chunk, H, P).to(f32)
    dt_ = dt.reshape(B, nc, chunk, H)
    b_ = bv.reshape(B, nc, chunk, N)
    c_ = cv.reshape(B, nc, chunk, N)

    dA = dt_ * a                                              # (B,nc,l,H), <= 0
    dA_cs = torch.cumsum(dA, dim=2)                           # inclusive

    # ---- intra-chunk (quadratic in the chunk length) ----
    # L[t, j] = exp(sum_{j < t' <= t} dA_t') for t >= j
    diff = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]  # (B,nc,t,j,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None],
                              torch.clamp(diff, max=0.0),
                              torch.tensor(float("-inf"), device=xh.device)))
    del diff
    scores = c_ @ b_.transpose(-1, -2)                         # (B,nc,t,j)
    m = scores[..., None] * L                                  # (B,nc,t,j,H)
    del L
    dtx = dt_[..., None] * x_                                  # (B,nc,j,H,P)
    y_intra = (m.permute(0, 1, 4, 2, 3) @ dtx.permute(0, 1, 3, 2, 4)
               ).permute(0, 1, 3, 2, 4)                        # (B,nc,t,H,P)
    del m

    # ---- chunk states ----
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)      # (B,nc,l,H)
    wx = (decay_to_end * dt_)[..., None] * x_                  # (B,nc,j,H,P)
    states = (wx.permute(0, 1, 3, 4, 2).reshape(B, nc, H * P, chunk)
              @ b_).reshape(B, nc, H, P, N)                    # (B,nc,H,P,N)
    del wx

    # ---- inter-chunk recurrence: the state BEFORE each chunk ----
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                # (B,nc,H)
    s = (torch.zeros((B, H, P, N), dtype=f32, device=xh.device)
         if init_state is None else init_state.to(f32))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                      # (B,nc,H,P,N)

    # ---- inter-chunk contribution ----
    decay_in = torch.exp(dA_cs)                                # (B,nc,l,H)
    cs = (c_ @ s_prevs.reshape(B, nc, H * P, N).transpose(-1, -2)
          ).reshape(B, nc, chunk, H, P)
    y_inter = cs * decay_in[..., None]

    y = y_intra + y_inter + d_skip[None, None, None, :, None] * x_
    return y.reshape(B, S, H, P).to(xh.dtype), s


def ssd_step(x1: torch.Tensor, dt1: torch.Tensor, a: torch.Tensor,
             b1: torch.Tensor, c1: torch.Tensor, d_skip: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
    """One recurrent SSD step (decode): x1 (B, H, P), dt1 (B, H) f32, b1 / c1
    (B, N) f32, state (B, H, P, N) f32, advanced in place (the new state is
    computed from the old one whole, then written). Returns y1 (B, H, P)."""
    xf = x1.to(torch.float32)
    da = torch.exp(dt1 * a)                                    # (B,H)
    new = (state * da[:, :, None, None]
           + (dt1[:, :, None] * xf)[..., None] * b1[:, None, None, :])
    state.copy_(new)
    y = (new @ c1[:, None, :, None])[..., 0] + d_skip[None, :, None] * xf
    return y.to(x1.dtype)


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------


def _in_proj(p: dict, h: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx):
    """Shared by full/step: project the normed residual h -> z, x, B|C, dt."""
    z = dense(h, p["w_z"], quant=ctx.site_quant("w_z"))
    xin = dense(h, p["w_x"], quant=ctx.site_quant("w_x"))
    bc = torch.cat([dense(h, p["w_b"], quant=ctx.site_quant("w_b")),
                    dense(h, p["w_c"], quant=ctx.site_quant("w_c"))], dim=-1)
    dt = dense(h, p["w_dt"], quant=ctx.site_quant("w_dt")).to(torch.float32)
    return z, xin, bc, softplus(dt + p["dt_bias"])


def _gate_out(p, y, z, x_dtype, cfg: ArchConfig, ctx: ModelCtx):
    """Gated RMS norm of the scan's output, then the out projection."""
    g = (y.to(torch.float32) * silu(z.to(torch.float32))).to(x_dtype)
    return dense(rms_norm(g, p["gate_norm"], eps=cfg.norm_eps), p["w_out"],
                 quant=ctx.site_quant("w_out"))


def mamba_full(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: ModelCtx, *,
               return_cache: bool = False):
    """Full-sequence Mamba2 block (prefill) on the residual x (B, S, d):
    returns (out, cache or None)."""
    di, H, G, N, P, K = dims(cfg)
    B, S, _ = x.shape
    h = rms_norm(x, p["pre_norm"], eps=cfg.norm_eps)
    z, xin, bc, dt = _in_proj(p, h, cfg, ctx)

    with span("ssm.conv"):
        xc = conv_full(xin, p["conv_w_x"], p["conv_b_x"])
        bcc = conv_full(bc, p["conv_w_bc"], p["conv_b_bc"])
    bv = bcc[..., :N].to(torch.float32)
    cv = bcc[..., N:].to(torch.float32)

    a = -torch.exp(p["a_log"].to(torch.float32))
    with span("ssd.scan"):
        y, final_state = ssd_scan(xc.reshape(B, S, H, P), dt, a, bv, cv,
                                  p["d_skip"], cfg.ssm.chunk)
    out = _gate_out(p, y.reshape(B, S, di), z, x.dtype, cfg, ctx)
    if return_cache:
        return out, {"conv_x": _tail(xin, K - 1), "conv_bc": _tail(bc, K - 1),
                     "ssd": final_state}
    return out, None


def _tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """Last n steps of (B, S, C), left-padded with zeros if S < n."""
    S = x.shape[1]
    if S >= n:
        return x[:, S - n:].contiguous()
    return torch.nn.functional.pad(x, (0, 0, n - S, 0))


def mamba_step(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig,
               ctx: ModelCtx) -> torch.Tensor:
    """One-token recurrent Mamba2 step (decode) on x (B, 1, d); advances the
    per-layer ``cache`` {"conv_x", "conv_bc", "ssd"} in place and returns
    the block's output (B, 1, d)."""
    di, H, G, N, P, K = dims(cfg)
    B = x.shape[0]
    h = rms_norm(x[:, 0], p["pre_norm"], eps=cfg.norm_eps)      # (B, d)
    z, xin, bc, dt = _in_proj(p, h, cfg, ctx)

    with span("ssm.conv"):
        xc = conv_step(xin, cache["conv_x"], p["conv_w_x"], p["conv_b_x"])
        bcc = conv_step(bc, cache["conv_bc"], p["conv_w_bc"], p["conv_b_bc"])
    b1 = bcc[..., :N].to(torch.float32)
    c1 = bcc[..., N:].to(torch.float32)

    a = -torch.exp(p["a_log"].to(torch.float32))
    with span("ssd.step"):
        y = ssd_step(xc.reshape(B, H, P), dt, a, b1, c1, p["d_skip"],
                     cache["ssd"])
    return _gate_out(p, y.reshape(B, di), z, x.dtype, cfg, ctx)[:, None]
