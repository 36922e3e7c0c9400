"""End-to-end serving driver of the PyTorch port (the paper's kind:
inference).

Trains a small LM briefly so it has real structure, then serves batched
requests under every quantization mode and reports greedy-token agreement
with the BF16 reference — the deployment-shaped version of Tables III-V.

    PYTHONPATH=src python examples/torch_serve_quantized.py [--steps 120]
    PYTHONPATH=src python examples/torch_serve_quantized.py --device cpu

The counterpart of ``examples/serve_quantized.py`` on ``repro_torch`` alone,
with the same lines. On the card the ``impl=packed`` rows run the port's
kernels: kernel 1 and kernel 2's prefill form on the prompts' 96 rows,
kernel 2's decode form on each step's 4 rows, and with the HiF4 KV cache
also decode attention (kernel 3) and the per-token KV append. The qdq rows
are fake quantization in plain PyTorch, as in the reference. On the CPU
every kernel runs its plain PyTorch version. The prompts come from a
``torch.Generator`` seeded 1, as the reference's from ``PRNGKey(1)``;
:func:`serve_table` takes trained params and prompts, so it can serve any.
"""
import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.runtime import ServeConfig, TrainLoopConfig, serve, train
from repro_torch.runtime.serve_loop import (
    packed_weight_bytes,
    prepare_params_for_serving,
)

QDQ_FORMATS = ("hif4", "nvfp4", "nvfp4_pts", "mxfp4")
CHUNKS = {"remat": False, "attn_q_chunk": 32, "attn_k_chunk": 32}


def train_reduced(cfg, steps: int, device: torch.device):
    """``steps`` of the train loop on ``cfg`` (global batch 8, seq 64,
    unquantized): (params, history)."""
    params, _, hist = train(cfg, ModelCtx(**CHUNKS), TrainLoopConfig(
        steps=steps, global_batch=8, seq_len=64), device=device)
    return params, hist


def draw_prompts(cfg) -> dict:
    """4 prompts of 24 tokens."""
    gen = torch.Generator().manual_seed(1)
    return {"tokens": torch.randint(0, cfg.vocab, (4, 24), generator=gen)}


def serve_table(cfg, params, prompts: dict, new_tokens: int,
                device: torch.device) -> tuple[list, list]:
    """Serve ``prompts`` under every mode: (printed lines, rows). A row is
    {"mode", "agree" (percent), "tokens", "params" (as served), "ctx",
    "serve_cfg"}, and for the packed rows "bytes_per_value"; the HiF4-KV
    row also "kv_bytes" and "kv_bf16" (per token, all layers), the policy
    row "sites_packed" and "sites"."""
    sc = ServeConfig(max_new_tokens=new_tokens)
    rows = []

    def run(mode, p, ctx, serve_cfg=sc, **extra):
        toks = serve(cfg, p, prompts, ctx, serve_cfg, device=device)
        agree = (100.0 if not rows else
                 float(torch.mean((toks == rows[0]["tokens"]).float())) * 100)
        rows.append(dict(mode=mode, agree=agree, tokens=toks, params=p,
                         ctx=ctx, serve_cfg=serve_cfg, **extra))
        return rows[-1]

    run("bf16", params, ModelCtx(**CHUNKS))
    lines = ["", f"batched serving: {prompts['tokens'].shape[0]} requests, "
                 f"{new_tokens} new tokens each",
             f"{'mode':22} {'agreement with bf16':>20}",
             f"{'bf16':22} {'100.0%':>20}"]
    for fmt in QDQ_FORMATS:
        r = run(fmt, params, ModelCtx(quant=QuantConfig(fmt=fmt), **CHUNKS))
        lines.append(f"{fmt:22} {r['agree']:19.1f}%")

    # hif4 again, but served from REAL 4.5-bit packed buffers (impl='packed'
    # — the deployment artifact). Same quantized values, 0.5625 B/value of
    # weight residency.
    qp = QuantConfig(fmt="hif4", impl="packed")
    ctx = ModelCtx(quant=qp, **CHUNKS)
    serving_params = prepare_params_for_serving(params, cfg, qp, device=device)
    nbytes, nvals = packed_weight_bytes(serving_params)
    r = run("hif4 (impl=packed)", serving_params, ctx,
            bytes_per_value=nbytes / nvals)
    lines.append(f"{'hif4 (impl=packed)':22} {r['agree']:19.1f}%"
                 f"   [{nbytes / nvals:.4f} B/value resident]")

    # ... and with the KV cache ALSO packed at 4.5 bits/value
    # (kv_format='hif4', repro_torch.core.kvcache): the cache is the term
    # that grows with slots x capacity, so this is what buys serving scale.
    a = cfg.attn
    kv_tok = kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head,
                                        "hif4") * cfg.n_layers
    kv_bf16 = kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head,
                                         "bf16") * cfg.n_layers
    r = run("hif4 + hif4 kv cache", serving_params, ctx,
            ServeConfig(max_new_tokens=new_tokens, kv_format="hif4"),
            bytes_per_value=nbytes / nvals, kv_bytes=kv_tok, kv_bf16=kv_bf16)
    lines.append(f"{'hif4 + hif4 kv cache':22} {r['agree']:19.1f}%"
                 f"   [kv {kv_tok} B/token vs bf16 {kv_bf16} "
                 f"-> {kv_bf16 / kv_tok:.2f}x slots]")

    # MIXED per-site policy (repro_torch.core.policy): the sensitive-fallback
    # preset keeps the outlier-sensitive output/down projections bf16 dense
    # while the rest of the body serves packed — placement is a rule list
    # resolved into a site plan, not a code edit.
    plan = lm.quant_plan(cfg, get_policy("sensitive-fallback", impl="packed"))
    pctx = ModelCtx(quant=plan.base, plan=plan, **CHUNKS)
    mixed_params = prepare_params_for_serving(params, cfg, plan, device=device)
    nbytes_m, nvals_m = packed_weight_bytes(mixed_params)
    r = run("policy: sens-fallback", mixed_params, pctx,
            bytes_per_value=nbytes_m / max(nvals_m, 1),
            sites_packed=len(plan.packed_paths), sites=len(plan.sites))
    lines.append(f"{'policy: sens-fallback':22} {r['agree']:19.1f}%"
                 f"   [{len(plan.packed_paths)}/{len(plan.sites)} sites packed, "
                 f"{nbytes_m / max(nvals_m, 1):.4f} B/value on packed sites]")
    return lines, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train briefly, then serve "
                                             "under every quantization mode")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where it runs (cuda, or cpu when asked)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    print(f"training reduced {args.arch} for {args.steps} steps ...")
    params, hist = train_reduced(cfg, args.steps, device)
    print(f"  loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")
    lines, _ = serve_table(cfg, params, draw_prompts(cfg), args.new_tokens,
                           device)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
