"""Fault-tolerant training loop (port of ``repro/runtime/train_loop.py``).

* resumes from the latest valid checkpoint (params, opt state and the data
  iterator's {step, seed}): a run killed anywhere and restarted follows the
  uninterrupted run's trajectory;
* async checkpoints every ``checkpoint_every`` steps (the tree is copied to
  host memory, then written on a thread while the next steps run);
* a step-time straggler monitor: a step slower than ``STRAGGLER_FACTOR``
  x the trailing median of 20 steps is flagged.

A step's time runs from the batch's hand-over to ``loss.item()`` (the
loss's host read waits for the step's device work). The loop runs under
``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set if the caller has not set it): the
embedding's backward and the loss's gather backward take their
deterministic CUDA implementations, so a resumed run repeats the
uninterrupted one's losses; an op with no deterministic implementation on
CUDA (the SSD scan's float ``cumsum``) warns instead of raising.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, load_checkpoint
from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.models.params import map_specs
from repro_torch.checkpoint.checkpoint import tree_flatten
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_init_specs

STRAGGLER_FACTOR = 3.0


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    num_microbatches: int = 1
    seed: int = 0


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block, restored
    after."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _restore(directory: str, step: int, cfg: ArchConfig, device):
    """(params, opt_state, extra) of checkpoint ``step`` on ``device``."""
    pspecs = lm.abstract_params(cfg)

    def target(p):
        return torch.empty(p.shape, dtype=p.dtype, device="meta")

    tree = (map_specs(target, pspecs), map_specs(target, adamw_init_specs(pspecs)))
    (params, opt_state), extra = load_checkpoint(directory, step, tree,
                                                 device=device)
    return params, opt_state, extra


def train(cfg: ArchConfig, ctx: ModelCtx, loop: TrainLoopConfig,
          opt_cfg: Optional[AdamWConfig] = None,
          on_step: Optional[Callable[[int, dict], None]] = None, *,
          device: DeviceLike = None, params: Optional[dict] = None,
          draw_on_device: bool = False, data=None):
    """Returns (params, opt_state, history {"loss", "step_time",
    "stragglers"}). ``params`` are the initial weights (default
    ``lm.init_params(cfg, loop.seed)``, drawn on ``device`` with
    ``draw_on_device``); a checkpoint in ``loop.checkpoint_dir`` takes
    precedence over both. The initial params are updated in place.
    ``data`` is the batch source (default the synthetic stream of
    ``loop``): anything with ``batch_at(step)``, a ``step`` attribute and
    ``state_dict`` / ``load_state_dict``."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3, total_steps=loop.steps,
                                     warmup_steps=max(1, loop.steps // 10))
    if data is None:
        data = SyntheticLMDataset(cfg.vocab, loop.seq_len, loop.global_batch,
                                  seed=loop.seed)
    start_step, opt_state = 0, None
    if loop.checkpoint_dir:
        s = latest_step(loop.checkpoint_dir)
        if s is not None:
            params, opt_state, extra = _restore(loop.checkpoint_dir, s, cfg, dev)
            data.load_state_dict(extra["data"])
            start_step = int(extra["step"])
    if opt_state is None:
        if params is None:
            params = lm.init_params(cfg, loop.seed, device=dev,
                                    draw_on_device=draw_on_device)
        opt_state = adamw_init(params)

    step_fn = make_train_step(cfg, ctx, opt_cfg,
                              num_microbatches=loop.num_microbatches)
    mgr = CheckpointManager(loop.checkpoint_dir) if loop.checkpoint_dir else None
    history = {"loss": [], "step_time": [], "stragglers": []}
    times: list[float] = []
    with deterministic_algorithms():
        for step in range(start_step, loop.steps):
            batch = {k: v.to(dev) for k, v in data.batch_at(step).items()}
            data.step = step + 1
            t0 = time.perf_counter()
            params, opt_state, stats = step_fn(params, opt_state, batch)
            loss = stats["loss"].item()
            dt = time.perf_counter() - t0
            times.append(dt)
            history["loss"].append(loss)
            history["step_time"].append(dt)
            # straggler detection against the trailing median
            if len(times) >= 5 and dt > STRAGGLER_FACTOR * \
                    statistics.median(times[-20:]):
                history["stragglers"].append(step)
            if on_step:
                on_step(step, {"loss": loss, "time": dt})
            if mgr and (step + 1) % loop.checkpoint_every == 0:
                mgr.save_async(step + 1, (params, opt_state),
                               {"step": step + 1, "data": data.state_dict()})
    if mgr:
        mgr.save_async(loop.steps, (params, opt_state),
                       {"step": loop.steps, "data": data.state_dict()})
        mgr.wait()
    for p in tree_flatten(params):
        p.requires_grad_(False)
    return params, opt_state, history
