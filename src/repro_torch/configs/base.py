"""Config system: architecture configuration and the registry.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
from that package); keep the two in step.

Every assigned architecture is a frozen :class:`ArchConfig` registered under
its id; ``--arch <id>`` in the launchers resolves through
:func:`get_arch`. ``ArchConfig.reduced()`` yields the scaled-down variant
used by CPU smoke tests (same family/features, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    d_ff: int = 0
    activation: str = "swiglu"      # swiglu | squared_relu | gelu
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0      # zamba2: shared attn block every N layers
    enc_layers: int = 0             # whisper: encoder depth (enc-dec if > 0)
    embeds_input: bool = False      # vlm/audio: frontend stub feeds embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    source: str = ""                # provenance tag from the assignment

    # ----- derived -----
    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid only; see DESIGN.md SS6)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    def n_params(self) -> int:
        """Approximate parameter count (embedding included)."""
        d, L = self.d_model, self.n_layers
        p = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attn is not None:
            a = self.attn
            per_layer += d * a.n_heads * a.d_head * 2          # q, o
            per_layer += d * a.n_kv_heads * a.d_head * 2       # k, v
        if self.moe is not None:
            m = self.moe
            n_mats = 3 if self.activation == "swiglu" else 2
            per_layer += m.n_experts * d * m.d_expert * n_mats + d * m.n_experts
        elif self.d_ff:
            n_mats = 3 if self.activation == "swiglu" else 2
            per_layer += d * self.d_ff * n_mats
        if self.ssm is not None:
            s = self.ssm
            di = s.expand * d
            n_heads = di // s.head_dim
            conv_dim = di + 2 * s.n_groups * s.d_state
            per_layer += d * (2 * di + 2 * s.n_groups * s.d_state + n_heads)
            per_layer += conv_dim * s.conv_kernel + di * d
        n_body = L if not self.is_encdec else L + self.enc_layers
        if self.hybrid_attn_every and self.attn is not None:
            # shared attention block counted once, not per invocation
            a = self.attn
            shared = d * (a.n_heads + 2 * a.n_kv_heads) * a.d_head + a.n_heads * a.d_head * d
            shared += d * self.d_ff * (3 if self.activation == "swiglu" else 2)
            ssm_layers = L
            return p + ssm_layers * per_layer + shared
        return p + n_body * per_layer

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        n_mats = 3 if self.activation == "swiglu" else 2
        inactive = (m.n_experts - m.top_k) * self.d_model * m.d_expert * n_mats
        return self.n_params() - self.n_layers * inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=128,
            vocab=512,
            d_ff=256 if self.d_ff else 0,
        )
        if self.attn is not None:
            kw["attn"] = dataclasses.replace(
                self.attn,
                n_heads=4,
                n_kv_heads=max(1, 4 * self.attn.n_kv_heads // self.attn.n_heads),
                d_head=32,
            )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=4,
                top_k=min(2, self.moe.top_k),
                d_expert=128,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=32, chunk=32)
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 1
        if self.enc_layers:
            kw["enc_layers"] = 2
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCHES: dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _ARCHES[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return _ARCHES[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; have {sorted(_ARCHES)}")


def all_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_ARCHES)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    # import every config module once so registration side effects run
    from repro_torch.configs import (  # noqa: F401
        granite_moe_1b,
        llava_next_34b,
        mamba2_1p3b,
        nemotron_4_340b,
        phi35_moe,
        qwen15_0p5b,
        qwen15_4b,
        qwen3_4b,
        whisper_tiny,
        zamba2_2p7b,
    )

    _LOADED = True
