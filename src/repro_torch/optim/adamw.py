"""AdamW from scratch: decoupled weight decay, global-norm clip, warmup then
cosine (port of ``repro/optim/adamw.py``).

The moments are f32 whatever the parameters' dtype, and the opt state is
``{"m": tree, "v": tree, "step": int32 0-dim}``, the reference's tree (so a
checkpoint of either package restores in the other). The update runs under
``torch.no_grad()`` and writes the parameters and moments in place, as the
reference's jitted step with donated buffers does, in the reference's
order: clip scale, moments, bias correction, then the decayed step in f32
cast back to the parameter's dtype. The schedule's ``cos`` and the bias
corrections' ``pow`` are PyTorch's f32 ops, which may differ from XLA's in
the last bit.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.checkpoint.checkpoint import tree_flatten, tree_unflatten
from repro_torch.models.params import PSpec, map_specs


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine to ``lr * min_lr_ratio``; f32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init_specs(param_specs) -> dict:
    """Abstract opt-state specs: zero f32 moments shaped as the params."""
    def f32_like(p: PSpec) -> PSpec:
        return dataclasses.replace(p, dtype=torch.float32, init="zeros")

    return {"m": map_specs(f32_like, param_specs),
            "v": map_specs(f32_like, param_specs),
            "step": PSpec((), (), dtype=torch.int32, init="zeros")}


def adamw_init(params) -> dict:
    """Zero opt state for a parameter tree, on the parameters' devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = tree_flatten(params)
    return {"m": tree_unflatten(params, [zeros(p) for p in leaves]),
            "v": tree_unflatten(params, [zeros(p) for p in leaves]),
            "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = 0
    for x in tree_flatten(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, cfg: AdamWConfig) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state``. Returns the
    stats {"grad_norm", "lr"} (0-dim f32 tensors on the device)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    for p, g, m, v in zip(tree_flatten(params), tree_flatten(grads),
                          tree_flatten(opt_state["m"]),
                          tree_flatten(opt_state["v"])):
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    opt_state["step"].copy_(step)
    return {"grad_norm": gnorm, "lr": lr}
