"""Abstract input specs for every (architecture x shape) cell (port of
``repro/launch/specs.py``).

A PSpec tree describes a step's inputs without allocating them; the dry run
turns it into tensors on the ``meta`` device:

  train   -> {"tokens"} | {"embeds", "labels"} | {"frames", "tokens"}
  prefill -> the same minus labels
  decode  -> {"token"} plus the decode-cache spec (KV of seq_len capacity,
             bf16: the reference's default)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.params import PSpec


def _tokens(b: int, s: int) -> PSpec:
    return PSpec((b, s), ("batch", "act_seq"), dtype=torch.int32, init="zeros")


def _embeds(b: int, s: int, d: int) -> PSpec:
    return PSpec((b, s, d), ("batch", "act_seq", None), dtype=torch.bfloat16)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Specs for a train/prefill batch."""
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind
    if cfg.family == "audio":
        # seq_len = encoder frames; the decoder context matches for train
        out = {"frames": _embeds(b, s, cfg.d_model)}
        if kind == "train":
            out["tokens"] = _tokens(b, s)
        return out
    if cfg.embeds_input:
        out = {"embeds": _embeds(b, s, cfg.d_model)}
        if kind == "train":
            out["labels"] = _tokens(b, s)
        return out
    return {"tokens": _tokens(b, s)}


def decode_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Specs for a serve_step: next token ids + cache at seq_len capacity."""
    b, s = shape.global_batch, shape.seq_len
    return {
        "token": PSpec((b,), ("batch",), dtype=torch.int32, init="zeros"),
        "cache": lm.abstract_cache(cfg, b, s),
    }
