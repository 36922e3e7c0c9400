#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure ends the run with a nonzero exit):

1. device  — a CUDA device, its name and power limit (nvidia-smi);
2. build   — the three CUDA kernels of src/repro_torch/csrc, built with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes of the main path, with times (CUDA events) beside
             the least time the card could take (bound_ms) and a library
             yardstick where PyTorch has one;
4. serve   — the main path: full-width qwen1.5-0.5b, policy paper-iv, impl
             packed, HiF4 KV cache, batch 8, prompt 480, 32 new tokens,
             random weights from --seed; the launch counters must show every
             kernel ran the expected number of times;
5. e2e     — a 2-layer cut of the same width, one set of weights, served
             on the card through the kernels, on the card through the plain
             versions (prefill logits must be bitwise equal), and on the CPU
             (at most 1% of the prefill logits outside rtol=0.05, atol=0.1:
             PyTorch's own float ops differ between CPU and GPU in the last
             bit, and HiF4 activation quantization amplifies those flips).
             Greedy tokens must agree, or differ only where the reference's
             top-2 logit gap is within that tolerance.

The last lines are the kernel records as one JSON object, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX and exits nonzero without a CUDA device or without the
repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def cuda_ms(fn, args_list, iters: int = 50, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``args_list``
    (distinct buffers, so the L2 cache does not hold them between calls)."""
    import torch

    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain
# ---------------------------------------------------------------------------


def check_quantize(dev, records):
    import torch
    from repro_torch.kernels.hif4_quant import absorbed_activation, hif4_quantize

    gen = torch.Generator().manual_seed(11)
    cases = []
    for m, k in ((8, 1024), (8, 2816), (3840, 1024)):
        scale = torch.exp(torch.empty(m, k // 64, 1).uniform_(-30, 30, generator=gen))
        x = (torch.randn(m, k // 64, 64, generator=gen) * scale).reshape(m, k)
        cases.append((f"({m}, {k})", x.to(torch.bfloat16)))
    edge = torch.zeros(8, 1024)
    edge[1] = 1e-39                                    # bf16 subnormals
    edge[2, ::3] = -3e-40
    edge[3] = 4.0 * torch.tensor([1.0, -1.0]).repeat(512)  # E1_8 threshold
    edge[4] = 2.0
    edge[4, ::7] = 7.0 * 2.0 ** 10                     # E1_16 threshold region
    edge[5] = 3.0e38                                   # huge magnitudes
    edge[5, ::2] = -1.0e38
    edge[6] = torch.arange(1024) * 2.0 ** -130
    edge[7] = 7.0 * 2.0 ** torch.arange(-64, 64).repeat(8)
    cases.append(("edge values", edge.to(torch.bfloat16)))
    worst = 0.0
    for label, x in cases:
        xd = x.to(dev)
        ki, ks = hif4_quantize(xd)
        pi, ps = absorbed_activation(xd)
        torch.cuda.synchronize()
        worst = max(worst, float((ki.float() - pi.float()).abs().max()),
                    float((ks - ps).abs().nan_to_num(float("inf")).max()))
        check(torch.equal(ki, pi), f"hif4_quantize {label}: ints differ at "
              f"{int((ki != pi).sum())} positions")
        check(torch.equal(ks.view(torch.int32), ps.view(torch.int32)),
              f"hif4_quantize {label}: scales differ")
        print(f"  hif4_quantize {label}: bitwise equal to the plain version")
    m, k = 8, 1024
    xs = [torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev) for _ in range(8)]
    ms = cuda_ms(hif4_quantize, [(x,) for x in xs], iters=200)
    plain_ms = cuda_ms(absorbed_activation, [(x,) for x in xs], iters=50)
    nbytes = m * k * 2 + m * k + m * (k // 64) * 4
    ops = 16 * m * k                     # f32 ops per value, lower estimate
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
    print(f"  hif4_quantize decode (8, 1024) bf16: kernel_ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} (bytes) "
          f"library_ms=n/a (no single PyTorch call)")
    records["hif4_quantize"] = {
        "name": "hif4_quantize", "route": "cuda",
        "source": "src/repro_torch/csrc/hif4_quant.cu",
        "replaces": "src/repro/kernels/hif4_quant.py:75",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "shape": "x (8, 1024) bf16"}


def check_matmul(dev, records):
    import torch
    from repro_torch.core import hif4
    from repro_torch.core.qlinear import PackedW
    from repro_torch.kernels.fused_matmul import (
        _tile_group_dot, fused_packed_matmul, fused_packed_matmul_plain)
    from repro_torch.kernels.hif4_quant import absorbed_activation

    gen = torch.Generator().manual_seed(12)
    worst = 0.0
    for k, n in ((1024, 1024), (1024, 2816), (2816, 1024)):
        w = (torch.randn(k, n, generator=gen) * 0.02).to(torch.bfloat16).to(dev)
        codes, meta = PackedW.from_dense(w).to_kernel_layout().kernel_operands()
        b_ints, b_sc = hif4.absorbed_int_km(codes, meta)
        for m in (8, 3840):
            x = torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev)
            ai, asc = absorbed_activation(x)
            y = fused_packed_matmul(ai, asc, codes, meta)
            ref = fused_packed_matmul_plain(ai, asc, codes, meta)
            rowabs = _tile_group_dot(ai.abs(), asc.abs(), b_ints.abs(), b_sc.abs())
            torch.cuda.synchronize()
            err = (y - ref).abs()
            worst = max(worst, float(err.max()))
            ok = bool((err <= 1e-5 * rowabs + 1e-30).all())
            check(ok, f"fused_packed_matmul M={m} K={k} N={n}: max |d| "
                  f"{float(err.max())} beyond 1e-5 of the row abs sum")
            print(f"  fused_packed_matmul M={m} K={k} N={n}: max |d| "
                  f"{float(err.max()):.3e} (bitwise: {torch.equal(y, ref)})")
    m, k, n = 8, 1024, 2816
    copies = []
    for _ in range(64):              # 64 x 1.6 MB > the 50 MB L2
        w = (torch.randn(k, n, generator=gen) * 0.02).to(torch.bfloat16).to(dev)
        codes, meta = PackedW.from_dense(w).to_kernel_layout().kernel_operands()
        copies.append((codes, meta, w))
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev)
    ai, asc = absorbed_activation(x)
    ms = cuda_ms(fused_packed_matmul, [(ai, asc, c, mt) for c, mt, _ in copies], iters=200)
    plain_ms = cuda_ms(fused_packed_matmul_plain,
                       [(ai, asc, c, mt) for c, mt, _ in copies], iters=50)
    library_ms = cuda_ms(torch.matmul, [(x, w) for _, _, w in copies], iters=200)
    nbytes = m * k + m * (k // 64) * 4 + k * n // 2 + (k // 64) * n * 4 + m * n * 4
    ops = 2 * m * n * k
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
    print(f"  fused_packed_matmul decode M=8 K=1024 N=2816: kernel_ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} (bytes) "
          f"library_ms={library_ms:.5f} (torch.matmul bf16 dense, not the "
          f"same function)")
    records["fused_packed_matmul"] = {
        "name": "fused_packed_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_matmul.cu",
        "replaces": "src/repro/kernels/fused_matmul.py:65",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
        "library": "torch.matmul bf16 dense (M,K)x(K,N), not the same function",
        "shape": "M=8 K=1024 N=2816"}


def _packed_cache(b, s, hkv, d, gen, dev):
    import torch
    from repro_torch.core import kvcache

    k = (torch.randn(b, s, hkv, d, generator=gen) * 0.5).to(torch.bfloat16)
    v = (torch.randn(b, s, hkv, d, generator=gen) * 0.5).to(torch.bfloat16)
    pk = kvcache.to_kernel_layout(kvcache.quantize_kv(k.to(dev)))
    pv = kvcache.to_kernel_layout(kvcache.quantize_kv(v.to(dev)))
    return pk, pv


def check_attention(dev, records):
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kvcache
    from repro_torch.kernels.fused_attention import (
        fused_decode_attention, fused_decode_attention_plain)

    gen = torch.Generator().manual_seed(13)
    B = 8
    worst = 0.0
    for hkv, d in ((16, 64), (4, 32)):
        for cap in (512, 160):
            pk, pv = _packed_cache(B, cap, hkv, d, gen, dev)
            q = (torch.randn(B, hkv, d, generator=gen) * 0.5).to(torch.bfloat16).to(dev)
            length = torch.tensor([1, 63, 64, 65, cap, cap - 1, 2, cap],
                                  dtype=torch.int32, device=dev)
            out = fused_decode_attention(q, pk, pv, length, n_kv_heads=hkv, d_head=d)
            ref = fused_decode_attention_plain(q, pk, pv, length, hkv, d)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            worst = max(worst, float(err.max()))
            tol = 1e-3 + 2 ** -7 * ref.float().abs()
            check(bool((err <= tol).all()),
                  f"fused_decode_attention hkv={hkv} d={d} cap={cap}: max |d| "
                  f"{float(err.max())} beyond rtol=2^-7, atol=1e-3")
            print(f"  fused_decode_attention Hkv={hkv} D={d} cap={cap}: max |d| "
                  f"{float(err.max()):.3e}")
            # an E6M2 0xFF meta word inside slot 3's valid prefix -> NaN there
            bad = {key: t.clone() for key, t in pk.items()}
            bad["meta"][3, 0, 5] |= -(1 << 24)       # scale byte 0xFF
            out = fused_decode_attention(q, bad, pv, length, n_kv_heads=hkv, d_head=d)
            ref = fused_decode_attention_plain(q, bad, pv, length, hkv, d)
            torch.cuda.synchronize()
            check(torch.equal(out.isnan(), ref.isnan()) and bool(out[3].isnan().any())
                  and not bool(out[[0, 1, 2, 4, 5, 6, 7]].isnan().any()),
                  f"fused_decode_attention hkv={hkv} d={d} cap={cap}: NaN "
                  f"propagation differs from the plain version")
    print("  fused_decode_attention: E6M2 0xFF meta -> NaN in its slot only, "
          "as in the plain version")
    hkv, d, cap = 16, 64, 512
    caches = [_packed_cache(B, cap, hkv, d, gen, dev) for _ in range(24)]
    q = (torch.randn(B, hkv, d, generator=gen) * 0.5).to(torch.bfloat16).to(dev)
    length = torch.full((B,), cap, dtype=torch.int32, device=dev)
    args = [(q, pk, pv, length) for pk, pv in caches]
    ms = cuda_ms(lambda *a: fused_decode_attention(*a, n_kv_heads=hkv, d_head=d),
                 args, iters=100)
    plain_ms = cuda_ms(lambda *a: fused_decode_attention_plain(*a, hkv, d), args,
                       iters=20)
    dense = [(q[:, :, None], kvcache.dequantize_kv(pk, hkv, d).transpose(1, 2),
              kvcache.dequantize_kv(pv, hkv, d).transpose(1, 2)) for pk, pv in caches]
    library_ms = cuda_ms(F.scaled_dot_product_attention, dense, iters=100)
    nbytes = 2 * kvcache.packed_kv_nbytes(caches[0][0]) + 2 * q.numel() * 2 + B * 4
    ops = 4 * B * hkv * cap * d
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S) * 1e3
    print(f"  fused_decode_attention decode B=8 Hkv=16 D=64 S=512: kernel_ms="
          f"{ms:.5f} plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} (bytes) "
          f"library_ms={library_ms:.5f} (scaled_dot_product_attention on the "
          f"dequantized bf16 K/V, not the same function)")
    records["fused_decode_attention"] = {
        "name": "fused_decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_attention.cu",
        "replaces": "src/repro/kernels/fused_attention.py:176",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
        "library": "scaled_dot_product_attention on dequantized bf16 K/V, "
                   "not the same function",
        "shape": "B=8 Hkv=16 D=64 S=512"}


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------


def serving_setup(cfg):
    from repro_torch.core import kvcache
    from repro_torch.core.policy import get_policy
    from repro_torch.models import lm
    from repro_torch.models.common import ModelCtx

    plan = lm.quant_plan(cfg, get_policy("paper-iv", impl="packed",
                                         kv=kvcache.KV_HIF4))
    return ModelCtx(plan=plan)


def phase_serve(dev, seed, records):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import kvcache
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        ServeConfig, packed_weight_bytes, prepare_params_for_serving, serve)

    cfg = get_arch("qwen1.5-0.5b")
    batch, prompt, new = 8, 480, 32
    ctx = serving_setup(cfg)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed, device="cpu")
    sparams = prepare_params_for_serving(params, cfg, ctx.plan, device=dev)
    del params
    torch.cuda.synchronize()
    print(f"  weights from seed {seed} packed on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    nbytes, nvals = packed_weight_bytes(sparams)
    print(f"  packed weight residency: {nbytes / 1e6:.1f} MB for {nvals} values "
          f"= {nbytes / nvals:.4f} B/value (bf16: {2 * nvals / 1e6:.1f} MB)")
    check(nbytes / nvals == 0.5625, "packed weights are not 0.5625 B/value")
    a = cfg.attn
    per_tok = kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head, "hif4") * cfg.n_layers
    bf16_tok = kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head, "bf16") * cfg.n_layers
    print(f"  kv bytes per token: {per_tok} B over {cfg.n_layers} layers "
          f"(bf16: {bf16_tok} B)")
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen)
    sc = ServeConfig(max_new_tokens=new)
    serve(cfg, sparams, {"tokens": tokens[:, :64]}, ctx,
          ServeConfig(max_new_tokens=2), device=dev)          # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    stats: dict = {}
    toks = serve(cfg, sparams, {"tokens": tokens}, ctx, sc, device=dev,
                 stats=stats)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    steps = stats["decode_steps"]
    print(f"  prefill {stats['prefill_s'] * 1e3:.1f} ms for {batch} x {prompt} "
          f"tokens; decode {stats['decode_s'] * 1e3 / steps:.2f} ms/token step "
          f"({batch * steps / stats['decode_s']:.1f} tokens/s over {steps} steps)")
    check(tuple(toks.shape) == (batch, new), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token ids out of range")
    sites = 7                                 # wq wk wv wo wg wu wo per layer
    want = {"hif4_quantize": cfg.n_layers * sites * (1 + steps),
            "fused_packed_matmul": cfg.n_layers * sites * (1 + steps),
            "fused_decode_attention": cfg.n_layers * steps}
    print(f"  launches on the main path: {launches} (expected {want})")
    check(launches == want, f"launch counts {launches} != expected {want}")
    for name, n in launches.items():
        records[name]["launches"] = n
    print(f"  request 0: {toks[0].tolist()}")


@contextlib.contextmanager
def plain_versions():
    """Route the engine's three kernel entry points to their plain PyTorch
    versions (for a run on the card that launches no kernel of the port)."""
    from repro_torch.core import engine
    from repro_torch.kernels.fused_attention import fused_decode_attention_plain
    from repro_torch.kernels.fused_matmul import fused_packed_matmul_plain
    from repro_torch.kernels.hif4_quant import absorbed_activation

    saved = (engine.hif4_quantize, engine.fused_packed_matmul,
             engine.fused_decode_attention)
    engine.hif4_quantize = absorbed_activation
    engine.fused_packed_matmul = fused_packed_matmul_plain
    engine.fused_decode_attention = (
        lambda q, k, v, length, *, n_kv_heads, d_head:
        fused_decode_attention_plain(q, k, v, length, n_kv_heads, d_head))
    try:
        yield
    finally:
        (engine.hif4_quantize, engine.fused_packed_matmul,
         engine.fused_decode_attention) = saved


def phase_e2e(dev, seed):
    """A 2-layer cut at full width from one set of weights, served three
    ways: on the card through the kernels, on the card through the plain
    versions, and on the CPU (plain versions)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        ServeConfig, build_decode_cache, prepare_params_for_serving, serve,
        serving_ctx)

    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"), n_layers=2)
    ctx = serving_setup(cfg)
    params = lm.init_params(cfg, seed + 2, device="cpu")
    gen = torch.Generator().manual_seed(seed + 3)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    sc = ServeConfig(max_new_tokens=8)
    runs = {}

    def run(name, d):
        sp = prepare_params_for_serving(params, cfg, ctx.plan, device=d)
        lg, _ = build_decode_cache(cfg, sp, {"tokens": tokens.to(d)},
                                   serving_ctx(ctx), sc)
        toks = serve(cfg, sp, {"tokens": tokens}, ctx, sc, device=d)
        runs[name] = (lg.float().cpu(), toks.cpu(), d)

    build.reset_launches()
    run("card", dev)
    check(all(n > 0 for n in build.LAUNCHES.values()),
          f"the card run launched {build.LAUNCHES}")
    with plain_versions():
        run("card-plain", dev)
    run("cpu", torch.device("cpu"))

    lg_k, toks_k, _ = runs["card"]
    lg_p, toks_p, _ = runs["card-plain"]
    print(f"  card kernels vs card plain versions: prefill logits bitwise "
          f"{torch.equal(lg_k, lg_p)}, greedy tokens equal "
          f"{torch.equal(toks_k, toks_p)}")
    check(torch.equal(lg_k, lg_p), "prefill logits: kernels != plain versions")
    _check_tokens("card kernels vs card plain", toks_k, "card-plain", runs,
                  cfg, params, ctx, tokens)

    lg_c, toks_c, _ = runs["cpu"]
    diff = (lg_k - lg_c).abs()
    outside = diff > 0.1 + 0.05 * lg_c.abs()
    share = float(outside.float().mean())
    print(f"  card vs cpu: prefill logits max |d| {float(diff.max()):.4f}, "
          f"mean |d| {float(diff.mean()):.5f} (|logits| max "
          f"{float(lg_c.abs().max()):.3f}); {int(outside.sum())} of "
          f"{outside.numel()} ({100 * share:.3f}%) outside rtol=0.05, atol=0.1")
    check(share <= 0.01, "more than 1% of the prefill logits outside "
          "rtol=0.05, atol=0.1 between card and cpu")
    _check_tokens("card vs cpu", toks_k, "cpu", runs, cfg, params, ctx, tokens)


def _check_tokens(label, toks, ref_name, runs, cfg, params, ctx, prompts):
    """Greedy tokens must equal the reference run's; where one differs, the
    reference's top-2 logit gap at that step must be within the tolerance."""
    import torch

    ref = runs[ref_name][1]
    print(f"  {label}: greedy tokens equal {torch.equal(toks, ref)}")
    for b in range(ref.shape[0]):
        idx = (toks[b] != ref[b]).nonzero()
        if not len(idx):
            continue
        step = int(idx[0])
        top1, top2 = _top2(cfg, params, ctx, prompts[b:b + 1], ref[b, :step],
                           runs[ref_name][2], plain=ref_name == "card-plain")
        gap = top1 - top2
        print(f"  request {b}: first differing token at step {step}; "
              f"{ref_name} top-2 logit gap {gap:.4f}")
        check(gap <= 0.1 + 0.05 * abs(top1), f"request {b} diverges at step "
              f"{step} with a top-2 gap {gap} beyond the tolerance")


def _top2(cfg, params, ctx, prompt, emitted, device, *, plain: bool):
    """The top two logits of a run at the step after the tokens ``emitted``
    (token 0 comes from the prefill logits)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        ServeConfig, build_decode_cache, prepare_params_for_serving, serving_ctx)

    with plain_versions() if plain else contextlib.nullcontext():
        sp = prepare_params_for_serving(params, cfg, ctx.plan, device=device)
        sctx = serving_ctx(ctx)
        logits, cache = build_decode_cache(
            cfg, sp, {"tokens": prompt.to(device)}, sctx,
            ServeConfig(max_new_tokens=len(emitted) + 1))
        for tok in emitted:
            logits, cache = lm.decode_step(
                sp, tok.reshape(1).to(device=device, dtype=torch.int32),
                cache, cfg, sctx)
    top = torch.topk(logits[0].float().cpu(), 2).values
    return float(top[0]), float(top[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of repro_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma list of phases to run (kernels,serve,e2e); "
                         "default all")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))

    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = card_line()
    records: dict = {}
    phases = [("kernels", lambda: (check_quantize(dev, records),
                                   check_matmul(dev, records),
                                   check_attention(dev, records))),
              ("serve", lambda: phase_serve(dev, args.seed, records)),
              ("e2e", lambda: phase_e2e(dev, args.seed))]
    try:
        print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
              f"torch {torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        secs = build.build_all()
        print(f"[build] {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())} "
              f"(wall {time.perf_counter() - t0:.1f} s, nvcc in parallel)")
        for name, fn in phases:
            if only and name not in only:
                continue
            t0 = time.perf_counter()
            print(f"[{name}]")
            fn()
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    except Exception as e:  # a failed phase ends the run with a nonzero exit
        import traceback

        traceback.print_exc()
        print(f"FAILED: {type(e).__name__}: {e}")
        return 1
    names = ["hif4_quantize", "fused_packed_matmul", "fused_decode_attention"]
    print(f"kernels: {json.dumps(names)}")
    if not only:
        print(json.dumps({"kernels": [records[n] for n in names]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
