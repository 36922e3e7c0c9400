"""The system under test: ``repro_torch`` served as a configuration file says.

Everything the benchmark takes from the program passes through here: the
architecture (checked against the configuration's numbers), the parameter
tree's shapes (checked against the reference's own table), the serving
artifact (``prepare_params_for_serving``, once, in set-up) and the call the
window drives, ``runtime.serve_loop.serve``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.policy import get_policy
from repro_torch.kernels import build
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.models.params import spec_leaves
from repro_torch.runtime import serve_loop

from hifbench.reference import draw
from hifbench.reference.model import leaf_table

DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def arch_config(conf: dict):
    """The ArchConfig a configuration file runs: the registered arch, cut
    to CPU-test size where ``base`` says so, with ``overrides`` (nested
    dicts apply to the attention and SSM sub-configs). Its numbers must be
    the file's ``model``, every one."""
    cfg = get_arch(conf["arch"])
    if conf.get("base") == "reduced":
        cfg = cfg.reduced()
    top = {}
    for key, val in conf.get("overrides", {}).items():
        if isinstance(val, dict):
            top[key] = dataclasses.replace(getattr(cfg, key), **val)
        else:
            top[key] = val
    cfg = dataclasses.replace(cfg, **top)
    numbers = model_numbers(cfg, conf["model"])
    if numbers != conf["model"]:
        diff = {k: (numbers[k], v) for k, v in conf["model"].items()
                if numbers[k] != v}
        raise ValueError(f"{conf['arch']}: the program's numbers differ from "
                         f"the configuration's (program, file): {diff}")
    return cfg


def model_numbers(cfg, keys) -> dict:
    """The program's value of each of ``keys``: a field of the ArchConfig
    or of one of its sub-configs (attention, MoE, SSM)."""
    fields = {}
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            fields.update(dataclasses.asdict(val))
        else:
            fields[f.name] = val
    missing = [k for k in keys if k not in fields]
    if missing:
        raise ValueError(f"{cfg.name}: no field {missing} in the program's config")
    return {k: fields[k] for k in keys}


def program_table(cfg) -> list:
    """The weight table of the program's own parameter tree (its paths,
    shapes, dtypes, initializers and scales)."""
    out = []
    for path, p in spec_leaves(lm.abstract_params(cfg)):
        out.append({"path": ".".join(path), "shape": list(p.shape),
                    "stacked": path[0] == "blocks", "dtype": DTYPE_NAMES[p.dtype],
                    "init": p.init, "std": p.std})
    return sorted(out, key=lambda x: tuple(x["path"].split(".")))


class Program:
    def __init__(self, conf: dict, device):
        self.conf = conf
        self.device = torch.device(device)
        self.cfg = arch_config(conf)
        self.numbers = conf["model"]
        mine = leaf_table(self.numbers)
        theirs = program_table(self.cfg)
        if mine != theirs:
            raise ValueError("the program's parameter tree differs from the "
                             "reference's weight table")
        self.table = leaf_table(self.numbers, conf.get("init"))
        self.plan = lm.quant_plan(self.cfg, get_policy(
            conf["policy"], impl=conf["impl"],
            kv=kvcache.KVCacheConfig(conf["kv_format"])))
        self.ctx = ModelCtx(quant=self.plan.base, plan=self.plan, remat=False,
                            **conf.get("ctx", {}))
        self.params = None

    def build_kernels(self) -> None:
        if self.device.type == "cuda":
            build.build_all()

    def load(self, seed: int) -> None:
        """Draw the weights on the device, layer by layer, and pack them
        into the serving artifact once."""
        self.free()
        raw = {}
        for leaf in self.table:
            node = raw
            *parents, name = leaf["path"].split(".")
            for key in parents:
                node = node.setdefault(key, {})
            node[name] = torch.empty(leaf["shape"], dtype=draw.DTYPES[leaf["dtype"]],
                                     device=self.device)
        for layer in range(-1, self.cfg.n_layers):
            for path, t in draw.draw_layer(self.table, seed, layer,
                                           self.device).items():
                node = raw
                *parents, name = path.split(".")
                for key in parents:
                    node = node[key]
                if layer >= 0:
                    node[name][layer].copy_(t)
                else:
                    node[name].copy_(t)
                del t
        self.params = serve_loop.prepare_params_for_serving(
            raw, self.cfg, self.plan, device=self.device)
        del raw
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def serve(self, tokens: torch.Tensor, new_tokens: int, stats: dict
              ) -> torch.Tensor:
        """One lockstep call: (B, S) prompts -> (B, new_tokens) tokens on the
        CPU; ``stats`` gets the program's prefill and decode times."""
        out = serve_loop.serve(self.cfg, self.params, {"tokens": tokens.to(self.device)},
                 self.ctx, serve_loop.ServeConfig(
                     max_new_tokens=new_tokens,
                     kv_format=self.conf["kv_format"]),
                 device=self.device, stats=stats)
        return out.cpu()

    def free(self) -> None:
        self.params = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
