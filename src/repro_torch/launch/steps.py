"""Step functions of the port (port of ``repro/launch/steps.py``):

  train_step   — loss + grads (optionally microbatched) + AdamW update
  prefill_step — prompt -> (first greedy token, decode cache)
  serve_step   — (cache, token) -> (next greedy token, cache); the decode unit

There is one device and no mesh, so the reference's sharding constraints
have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.checkpoint.checkpoint import tree_flatten, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def _grads(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf for every leaf (zeros where a leaf is unused)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def make_train_step(cfg: ArchConfig, ctx: ModelCtx, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    stats)``; params and opt state are updated in place and returned.

    With ``num_microbatches`` m > 1 the batch splits along its first axis
    into m equal microbatches; their gradients accumulate in f32 and their
    losses from an f32 zero, both then divided by m (the reference's scan).
    The gradients of one microbatch are the params' dtype (bf16), as the
    reference's ``value_and_grad`` gives."""
    m = num_microbatches

    def loss_fn(params, mb):
        return lm.train_loss(params, mb, cfg, ctx)

    def train_step(params, opt_state, batch):
        leaves = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        if m == 1:
            loss = loss_fn(params, batch)
            grads = _grads(loss, leaves)
            loss = loss.detach()
        else:
            for k, x in batch.items():
                if x.shape[0] % m:
                    raise ValueError(f"batch {k!r} of {x.shape[0]} rows does "
                                     f"not split into {m} microbatches")
            dev = leaves[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in leaves]
            for i in range(m):
                mb = {k: x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))[i]
                      for k, x in batch.items()}
                li = loss_fn(params, mb)
                with torch.no_grad():
                    grads = [a + g.to(torch.float32)
                             for a, g in zip(grads, _grads(li, leaves))]
                    loss = loss + li.detach()
            loss = loss / m
            grads = [g / m for g in grads]
        stats = adamw_update(params, tree_unflatten(params, grads), opt_state,
                             opt_cfg)
        return params, opt_state, dict(stats, loss=loss)

    return train_step


def make_prefill_step(cfg: ArchConfig, ctx: ModelCtx):
    def prefill_step(params, batch):
        logits, cache = lm.prefill(params, batch, cfg, ctx)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, ctx: ModelCtx):
    """One greedy decode step; the cache is advanced in place."""

    def serve_step(params, cache, token):
        logits, new_cache = lm.decode_step(params, token, cache, cfg, ctx)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache

    return serve_step
