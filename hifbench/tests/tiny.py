"""Cells of the CPU tests: the benchmark's two families cut to the port's
``.reduced()`` sizes, written into a temporary tree as a later change would
add a cell (a configuration, a mix, a cell file, entries in BENCHMARK.json)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from hifbench.harness.spec import ROOT

# widest logit gap of a tiny cell: the program reads at most 0.004 on the
# CPU, the fp8 control at least 0.07 (the dense chat cell; 0.14 the SSM's)
TINY_LIMIT = 0.02

DENSE = {"family": "dense", "n_layers": 2, "d_model": 128, "vocab": 512,
         "d_ff": 256, "activation": "squared_relu", "tie_embeddings": False,
         "norm_eps": 1e-05, "n_heads": 4, "n_kv_heads": 2, "d_head": 32,
         "rope_theta": 10000.0, "qkv_bias": False, "qk_norm": False}
SSM = {"family": "ssm", "n_layers": 2, "d_model": 128, "vocab": 512,
       "d_ff": 0, "activation": "swiglu", "tie_embeddings": True,
       "norm_eps": 1e-05, "d_state": 16, "expand": 2, "head_dim": 32,
       "n_groups": 1, "conv_kernel": 4, "chunk": 32}


def write_tree(root: Path) -> Path:
    """tiny-dense.chat, tiny-ssm.chat and tiny-dense.doc under ``root``."""
    here = root / "hifbench"
    for sub in ("configs", "traffic", "cells"):
        (here / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "hifbench" / "metrics", here / "metrics",
                    dirs_exist_ok=True)
    ssm_init = json.loads((ROOT / "hifbench" / "configs" / "mamba2-1.3b.json")
                          .read_text())["init"]
    configs = {
        "tiny-dense": {"arch": "nemotron-4-340b", "base": "reduced",
                       "overrides": {"attn": {"n_kv_heads": 2}}, "model": DENSE,
                       "impl": "packed", "policy": "paper-iv", "kv_format": "hif4",
                       "ctx": {"attn_q_chunk": 16, "attn_k_chunk": 16}, "init": {}},
        "tiny-ssm": {"arch": "mamba2-1.3b", "base": "reduced", "overrides": {},
                     "model": SSM, "impl": "packed", "policy": "paper-iv",
                     "kv_format": "bf16", "ctx": {}, "init": ssm_init}}
    mixes = {
        "chat": {"batch": 4, "prompt": {"law": "log_uniform", "low": 16, "high": 32,
                                        "multiple_of": 16, "levels": 1},
                 "new_tokens": 6, "trace_decode_steps": 2, "who": "tests"},
        "doc": {"batch": 1, "prompt": {"law": "log_uniform", "low": 32, "high": 64,
                                       "multiple_of": 16, "levels": 3},
                "new_tokens": 1, "trace_decode_steps": 0, "who": "tests"}}
    cells = {"tiny-dense.chat": ("tiny-dense", "chat"),
             "tiny-ssm.chat": ("tiny-ssm", "chat"),
             "tiny-dense.doc": ("tiny-dense", "doc")}
    for name, conf in configs.items():
        (here / "configs" / f"{name}.json").write_text(json.dumps(conf))
    for name, mix in mixes.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": c, "config": k, "traffic": t, "chips": 1,
                           "why": "CPU test"} for c, (k, t) in cells.items()]
    stand_in = {"nemotron-4-340b-l4.chat-b32": "tiny-dense.chat",
                "mamba2-1.3b.chat-b256": "tiny-ssm.chat",
                "nemotron-4-340b-l4.longdoc-b1": "tiny-dense.doc"}
    for met in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in met:
            met["workloads"] = [stand_in[w] for w in met["workloads"]
                                if w in stand_in]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for name in cells:
        (here / "cells" / f"{name}.json").write_text(json.dumps(
            {"sample_requests": 8, "limits": {"widest_logit_gap": TINY_LIMIT}}))
    return root
