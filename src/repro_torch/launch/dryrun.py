"""Dry run: every (arch x shape) cell at full width on the ``meta`` device
(port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for a 256- and a 512-chip mesh
and reads XLA's memory and cost analyses. The port runs on one card and has
no compiler to ask, so a cell here is the step itself (``launch/steps.py``)
dispatched on ``meta`` tensors under :mod:`repro_torch.launch.cost_analysis`
(loop-aware: costed at a few depths and extrapolated to the config's),
beside the analytic residency of its params, optimizer state and KV cache.
Nothing is allocated on any device, and no card is needed.

  python -m repro_torch dryrun --arch qwen1.5-0.5b --shape decode_32k
  python -m repro_torch dryrun --all
  python -m repro_torch dryrun --all --mesh both     # residency on 16x16, 2x16x16
  python -m repro_torch dryrun --arch qwen1.5-0.5b --shape train_4k --attn vec_q

``--mesh card`` (the default) costs the step on the card's constants
(``launch/mesh.py``) and states whether its peak fits the card
(``fits_card``, the counterpart of the reference's compile-time OOM).
``--mesh single|multi|both`` gives the reference's meshes, residency only
(params, opt_state and kv_cache per device under ``ShardCtx``): a per-device
roofline needs a partitioner and a multi-card machine, which the port does
not have. ``--attn`` picks the attention form a cell costs (``auto``:
``scan_q`` on the card, the reference's rule on its meshes); the record's
``attn_impl`` names it. One JSON record per cell goes under ``--out``
(default ``experiments/dryrun_torch/``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import (ArchConfig, ShapeConfig, all_archs,
                                      applicable_shapes, get_arch, get_shape)
from repro_torch.core.qlinear import QuantConfig
from repro_torch.launch import cost_analysis
from repro_torch.launch import mesh as hw
from repro_torch.launch.specs import batch_specs, decode_specs
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.models.params import PSpec, map_specs, spec_leaves
from repro_torch.optim.adamw import AdamWConfig, adamw_init_specs
from repro_torch.sharding.rules import ShardCtx

# Gradient-accumulation microbatches of the biggest train cells (the
# reference's choice for its meshes, kept so the cells are the same steps).
TRAIN_MICROBATCHES = {
    "nemotron-4-340b": 4,
    "llava-next-34b": 2,
    "phi3.5-moe-42b-a6.6b": 2,
    "qwen3-4b": 2,
    "qwen1.5-4b": 2,
    "zamba2-2.7b": 2,
    "mamba2-1.3b": 2,
}

# Sequence-parallel residual streams only for the big models (the
# reference's rule; it decides the "act_seq" axis of the residency).
SEQ_SHARD_MIN_PARAMS = 8e9

DEFAULT_OUT = os.path.join("experiments", "dryrun_torch")
MESH_FLAGS = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"], "card": ["card"]}
NO_ROOFLINE = ("residency only: a per-device roofline on this mesh needs a "
               "partitioner and a multi-card machine, which the port does "
               "not have")


def resident_bytes_per_device(spec_tree, shard: ShardCtx) -> int:
    """Analytic per-device residency of a PSpec tree (packed markers
    included) from its shard shapes."""
    total = 0
    for _, p in spec_leaves(spec_tree):
        shape = shard.shard_shape(p.axes, p.shape)
        total += math.prod(shape) * p.dtype.itemsize
    return total


def make_ctx(mesh: Optional[dict], quant: str, *, fsdp: bool,
             seq_shard: bool = True, attn_impl: str = "scan_q") -> tuple:
    """(ModelCtx, ShardCtx) of a cell: the model's quantization and
    attention form, and the sharding rules its residency is counted
    under."""
    shard = ShardCtx(mesh=mesh)
    overrides = {}
    if not fsdp:
        overrides["fsdp"] = ()
    if not seq_shard:
        overrides["act_seq"] = ()
    if overrides:
        shard = shard.with_rules(**overrides)
    return ModelCtx(quant=QuantConfig(fmt=quant), attn_impl=attn_impl), shard


def resolve_attn_impl(cfg: ArchConfig, mesh_axes: dict, attn_mode: str) -> str:
    """The attention form a cell runs (the reference's rule): ``vec_q`` when
    asked, or under ``auto`` where the head count does not divide the
    mesh's tensor-parallel axis; else ``scan_q``. On the card that axis is
    1, so ``auto`` is ``scan_q`` there."""
    if attn_mode == "vec_q":
        return "vec_q"
    tp = mesh_axes.get("model", 1)
    if (attn_mode == "auto" and cfg.attn is not None
            and cfg.attn.n_heads % tp != 0):
        return "vec_q"
    return "scan_q"


# ---------------------------------------------------------------------------
# Depth: each family's repeating period (the loop-aware count's knobs)
# ---------------------------------------------------------------------------


def depth_knobs(cfg: ArchConfig) -> tuple:
    """The config's repeat counts: (decoder-or-encoder layers,) per family's
    period; the audio family's encoder and decoder depths are two knobs."""
    if cfg.family == "audio":
        return (cfg.enc_layers, cfg.n_layers)
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.hybrid_attn_every,)
    return (cfg.n_layers,)


def at_depth(cfg: ArchConfig, knobs: tuple) -> ArchConfig:
    """``cfg`` with its repeat counts set to ``knobs``."""
    if cfg.family == "audio":
        return dataclasses.replace(cfg, enc_layers=knobs[0], n_layers=knobs[1])
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg,
                                   n_layers=knobs[0] * cfg.hybrid_attn_every)
    return dataclasses.replace(cfg, n_layers=knobs[0])


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def _meta(p: PSpec) -> torch.Tensor:
    return torch.empty(p.shape, dtype=p.dtype, device="meta")


def param_specs(cfg: ArchConfig, kind: str, quant: str, packed: bool) -> tuple:
    """(the param PSpec tree, packed?): the packed overlay of the uniform
    packed plan for serving cells under ``packed``, where it packs a site."""
    pspecs = lm.abstract_params(cfg)
    if not packed or kind == "train":
        return pspecs, False
    plan = lm.quant_plan(cfg, QuantConfig(fmt=quant, impl="packed"))
    if not plan.packed_paths:
        return pspecs, False
    return lm.packed_overlay(pspecs, plan), True


def make_cell_step(cfg: ArchConfig, shape: ShapeConfig, *, quant: str = "hif4",
                   microbatches: int = 1, attn_impl: str = "scan_q"):
    """The step a cell runs: the train step (AdamW, ``microbatches``), the
    prefill step or the serve step, under the dry run's context
    (inference: weights quantized once offline, no remat) and attention
    form. A card run of the cell calls the same step on real tensors."""
    ctx, _ = make_ctx(None, quant, fsdp=True, attn_impl=attn_impl)
    if shape.kind == "train":
        return make_train_step(cfg, ctx, AdamWConfig(),
                               num_microbatches=microbatches)
    qcfg = dataclasses.replace(ctx.quant, offline_weights=True)
    ctx = dataclasses.replace(ctx, quant=qcfg, remat=False)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, ctx)
    return make_serve_step(cfg, ctx)


def cell_specs(cfg: ArchConfig, shape: ShapeConfig, *, quant: str = "hif4",
               packed: bool = False) -> tuple:
    """The step's input PSpec trees in argument order: params, then
    opt_state and batch (train), batch (prefill), or cache and token
    (decode)."""
    pspecs, _ = param_specs(cfg, shape.kind, quant, packed)
    if shape.kind == "train":
        return pspecs, adamw_init_specs(pspecs), batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return pspecs, batch_specs(cfg, shape)
    dspecs = decode_specs(cfg, shape)
    return pspecs, dspecs["cache"], dspecs["token"]


def cell_step(cfg: ArchConfig, shape: ShapeConfig, *, quant: str = "hif4",
              packed: bool = False, microbatches: int = 1,
              attn_impl: str = "scan_q") -> tuple:
    """(step, args on ``meta`` tensors) of one cell."""
    specs = cell_specs(cfg, shape, quant=quant, packed=packed)
    args = (lm.realize_packed(specs[0], _meta),) + tuple(
        _meta(s) if isinstance(s, PSpec) else map_specs(_meta, s)
        for s in specs[1:])
    return make_cell_step(cfg, shape, quant=quant, microbatches=microbatches,
                          attn_impl=attn_impl), args


def dispatch_cost(cfg: ArchConfig, shape: ShapeConfig, *, regions=False,
                  replay_chunks=True, **kw) -> cost_analysis.Cost:
    """The cost of one dispatch of the cell's step at ``cfg``'s depth."""
    step, args = cell_step(cfg, shape, **kw)
    with torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
        return cost_analysis.count(step, *args, regions=regions,
                                   replay_chunks=replay_chunks)[1]


def loop_aware_cost(cfg: ArchConfig, shape: ShapeConfig, *, regions=False,
                    **kw) -> tuple:
    """(Cost at ``cfg``'s depth, region multiplicities): the step costed at
    :func:`cost_analysis.sample_points` of its depth knobs (two periods,
    three, and four for a train step) and extrapolated."""
    degree = 2 if shape.kind == "train" else 1
    target = depth_knobs(cfg)
    samples = [(k, dispatch_cost(at_depth(cfg, k), shape, regions=regions, **kw))
               for k in cost_analysis.sample_points(len(target), degree)]
    return cost_analysis.extrapolate(samples, target, degree)


def cell_config(arch: str, layers: Optional[int] = None) -> ArchConfig:
    """The arch's config, its depth cut to ``layers`` periods (a card run's
    cut; the audio family's two depths are not cut)."""
    cfg = get_arch(arch)
    if layers is None:
        return cfg
    if len(depth_knobs(cfg)) != 1:
        raise ValueError(f"{arch}: a depth cut takes one depth knob, the "
                         f"{cfg.family} family has {len(depth_knobs(cfg))}")
    return at_depth(cfg, (layers,))


def cell_shape(shape_name: str, batch: Optional[int]) -> ShapeConfig:
    shape = get_shape(shape_name)
    return (dataclasses.replace(shape, global_batch=batch) if batch
            else shape)


def residency_record(arch: str, shape_name: str, *, mesh: str = "card",
                     quant: str = "hif4", fsdp: bool = True,
                     seq_shard: Optional[bool] = None, microbatches: int = 0,
                     packed: bool = False, batch: Optional[int] = None,
                     attn_mode: str = "auto",
                     layers: Optional[int] = None) -> dict:
    """One cell's record without its cost: residency per device under the
    mesh's ``ShardCtx``, parameter counts, ``model_flops`` and the attention
    form (:func:`resolve_attn_impl`). ``batch`` cuts the shape's global
    batch and ``layers`` the depth (:func:`cell_config`), a card run's
    cuts."""
    cfg = cell_config(arch, layers)
    shape = cell_shape(shape_name, batch)
    mesh_axes = hw.MESHES[mesh]
    if seq_shard is None:  # auto: SP only where activation memory demands it
        seq_shard = cfg.n_params() >= SEQ_SHARD_MIN_PARAMS
    _, shard = make_ctx(mesh_axes, quant, fsdp=fsdp, seq_shard=seq_shard)
    mb = (microbatches or TRAIN_MICROBATCHES.get(arch, 1)
          if shape.kind == "train" else 1)
    pspecs, packed = param_specs(cfg, shape.kind, quant, packed)
    resident = {"params": resident_bytes_per_device(pspecs, shard)}
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    if shape.kind == "train":
        resident["opt_state"] = resident_bytes_per_device(
            adamw_init_specs(pspecs), shard)
        model_flops = 6.0 * cfg.n_active_params() * tokens
    elif shape.kind == "prefill":
        model_flops = 2.0 * cfg.n_active_params() * tokens
    else:
        resident["kv_cache"] = resident_bytes_per_device(
            decode_specs(cfg, shape)["cache"], shard)
        model_flops = 2.0 * cfg.n_active_params() * tokens
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh, "kind": shape.kind,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "quant": quant, "fsdp": fsdp, "seq_shard": seq_shard,
        "attn_impl": resolve_attn_impl(cfg, mesh_axes, attn_mode),
        "packed_weights": packed, "microbatches": mb,
        "n_devices": hw.mesh_devices(mesh_axes),
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "resident_bytes_per_device": resident, "model_flops": model_flops,
    }
    if shape.kind == "decode":
        # a hif4 serve of this cell may narrow to bf16 KV (the SSM-state
        # families have no packed layout): the record carries the resolution
        from repro_torch.runtime.serve_loop import (ServeConfig,
                                                    kv_format_fallback,
                                                    resolve_kv_format)

        q = QuantConfig(fmt=quant)
        req = ServeConfig(kv_format="hif4" if quant == "hif4" else None)
        record["kv_format"] = resolve_kv_format(cfg, q, req)
        record["kv_format_fallback"] = kv_format_fallback(cfg, q, req)
    record.update(memory=None, roofline=None, useful_flops_ratio=None,
                  fits_card=None)
    return record


def lower_cell(arch: str, shape_name: str, *, mesh: str = "card",
               quant: str = "hif4", fsdp: bool = True,
               seq_shard: Optional[bool] = None, microbatches: int = 0,
               attn_mode: str = "auto", packed: bool = False,
               batch: Optional[int] = None, regions: bool = False,
               layers: Optional[int] = None) -> tuple:
    """One cell -> (record, Cost or None, region multiplicities): the
    :func:`residency_record`, and on the card the step costed on ``meta``
    in the record's attention form."""
    record = residency_record(arch, shape_name, mesh=mesh, quant=quant,
                              fsdp=fsdp, seq_shard=seq_shard,
                              microbatches=microbatches, packed=packed,
                              batch=batch, attn_mode=attn_mode, layers=layers)
    if mesh != "card":
        record["roofline_note"] = NO_ROOFLINE
        return record, None, {}
    cfg, shape = cell_config(arch, layers), cell_shape(shape_name, batch)
    resident, model_flops = (record["resident_bytes_per_device"],
                             record["model_flops"])
    t0 = time.perf_counter()
    cost, mult = loop_aware_cost(cfg, shape, regions=regions, quant=quant,
                                 packed=record["packed_weights"],
                                 microbatches=record["microbatches"],
                                 attn_impl=record["attn_impl"])
    inputs = (decode_specs(cfg, shape)["token"] if shape.kind == "decode"
              else batch_specs(cfg, shape))
    argument_bytes = (sum(resident.values())
                      + resident_bytes_per_device(inputs, ShardCtx()))
    mem = cost_analysis.memory_stats(cost, argument_bytes)
    roof = cost_analysis.analyze(cost)
    record.update(
        cost_s=round(time.perf_counter() - t0, 2),
        memory=mem, roofline=roof,
        useful_flops_ratio=model_flops / max(roof["flops_per_device"], 1.0),
        fits_card=mem["peak_bytes_est"] <= hw.HBM_BYTES,
    )
    return record, cost, mult


def record_tag(rec: dict, args) -> str:
    tag = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}_{args.quant}"
    if args.fsdp == "off":
        tag += "_nofsdp"
    if args.no_seq_shard:
        tag += "_nosp"
    if args.attn != "auto":
        tag += f"_{args.attn}"
    if args.packed:
        tag += "_packed"
    return tag.replace("/", "-")


def run_cell(arch: str, shape_name: str, mesh: str, args) -> bool:
    key = f"{arch} x {shape_name} [{mesh}]"
    t0 = time.perf_counter()
    try:
        rec, _, _ = lower_cell(
            arch, shape_name, mesh=mesh, quant=args.quant,
            fsdp=args.fsdp != "off",
            seq_shard=False if args.no_seq_shard else None,
            microbatches=args.microbatches, attn_mode=args.attn,
            packed=args.packed)
    except Exception as e:
        traceback.print_exc()
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
               "quant": args.quant, "error": f"{type(e).__name__}: {e}"}
    rec["seconds"] = round(time.perf_counter() - t0, 2)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, record_tag(rec, args) + ".json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    if "error" in rec:
        print(f"FAIL {key}: {rec['error']}")
        return False
    res = " ".join(f"{k}={v / 2**30:.2f}GiB"
                   for k, v in rec["resident_bytes_per_device"].items())
    if rec["roofline"] is None:
        print(f"OK   {key}: {res} (residency only) {rec['seconds']}s")
        return True
    r, m = rec["roofline"], rec["memory"]
    print(f"OK   {key}: {res} peak={m['peak_bytes_est'] / 2**30:.2f}GiB "
          f"fits_card={'yes' if rec['fits_card'] else 'no'} "
          f"t_comp={r['t_compute_s'] * 1e3:.2f}ms "
          f"t_mem={r['t_memory_s'] * 1e3:.2f}ms dom={r['dominant']} "
          f"useful={rec['useful_flops_ratio']:.2f} {rec['seconds']}s")
    return True


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"],
                    default="card")
    ap.add_argument("--quant", default="hif4")
    ap.add_argument("--fsdp", choices=["on", "off"], default="on")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--attn", choices=["auto", "scan_q", "vec_q"], default="auto")
    ap.add_argument("--packed", action="store_true",
                    help="serve cells with 4.5-bit PackedW resident weights")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.all:
        cells = [(a, s) for a in all_archs()
                 for s in applicable_shapes(get_arch(a))]
    else:
        if not args.arch:
            print("--arch is required without --all", file=sys.stderr)
            return 2
        shapes = ([args.shape] if args.shape
                  else applicable_shapes(get_arch(args.arch)))
        cells = [(args.arch, s) for s in shapes]
    ok = fail = 0
    for mesh in MESH_FLAGS[args.mesh]:
        for arch, shape in cells:
            if run_cell(arch, shape, mesh, args):
                ok += 1
            else:
                fail += 1
    print(f"\n{ok} cells passed, {fail} failed")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
