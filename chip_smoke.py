#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure ends the run with a nonzero exit):

1. device  — a CUDA device, its name and power limit (nvidia-smi);
2. build   — the CUDA kernels of src/repro_torch/csrc (seven sources, eight
             kernels), built with nvcc, one process per source in parallel;
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes of the main paths, with times beside the least time
             the card could take (bound_ms) and a library yardstick where
             PyTorch has one: kernel_ms (CUDA events around the eager loop
             of wrapper calls, so host dispatch shows where the host is the
             slower side), device_ms (the same calls captured in a CUDA
             graph, its replays timed) and host_us (host clock per wrapper
             call); kernel 1 also at the prefill and tied embedding's
             shapes; kernel 2 called directly bitwise at M 8, 33, 300 and
             3840 (above 32 rows the int8 tensor-core body) in f32 and bf16
             out, its prefill form timed at the main path's three prefill
             shapes (launch-weighted, with the promotion's CUDA-core floor
             beside the bound and torch._int_mm beside torch.matmul as
             yardsticks); kernel 5 bitwise against kernel 2 on the absorbed
             expansion of a packed weight; the decode form of kernel 2
             (kernel 1 as its prologue) bitwise against its plain version
             and kernel 5 at the three decode shapes, timed beside the pair
             it replaces; kernel 5 (M <= 32: the decode body) bitwise at the
             LM head and ragged shapes, and its decode form (the weight's
             Algorithm 1 in its loader) bitwise against its plain version
             and kernel 1 then kernel 5, timed at the LM head beside that
             pair, with the bytes bound and Algorithm 1's issue floor
             (cuobjdump); kernels 3 and 4 also timed at a solo serve's
             tiling (there the models-level decode_attention_packed within
             rtol 2^-7, atol 1e-3 of kernel 3) and on the paged phase's
             ragged table (trailing
             scratch entries, partial pages), kernel 4 bitwise kernel 3 at
             block_kv = P at 1, 2, 3, 8 and 33 tiles, a slot of length 0
             bitwise its plain version, a NaN V scale in the scratch page
             reaching exactly the slots with trailing entries; the per-token
             KV append (K and V of a layer in one launch) bitwise its plain
             version at qwen's decode shape (B 8, Hkv 16, D 64), contiguous
             and paged (a ragged table; page 0, where retired slots collide,
             left out), NaN, +-Inf, zeros and bf16's top among the tokens,
             timed beside its bytes bound;
4. serve   — the main path: full-width qwen1.5-0.5b, policy paper-iv, impl
             packed, HiF4 KV cache, batch 8, prompt 480, 32 new tokens,
             random weights from --seed; the launch counters must show every
             kernel ran the expected number of times (decode linears: one
             launch of the decode form each; one KV append a layer a
             decode step);
5. pallas  — the same serve under impl pallas with a policy that quantizes
             the tied LM head (paper-iv's rules without its lm_head
             exclusion): per logits call (8 rows) kernel 1 on the
             activations, then kernel 5's decode form, which quantizes the
             embedding in its loader; weights at 5x the init's scale,
             so tokens vary; exact launch counts; the head at the last
             decode step bitwise equal to its plain versions; then the same
             weights under nvfp4-baseline (kernels 2 and 5 never run), the
             four formats' qdq on the card bitwise equal to the CPU, and the
             quantized matmul of kernels.ops within 20% of the f32 product
             and closer than MXFP4;
6. e2e     — a 2-layer cut of the same width, one set of weights, under
             paper-iv and under the head policy, served on the card through
             the kernels, on the card through the plain versions (prefill
             logits must be bitwise equal), and on the CPU: under paper-iv
             at most 1% of the prefill logits outside rtol=0.05, atol=0.1
             (PyTorch's own float ops differ between CPU and GPU in the last
             bit, and HiF4 activation quantization amplifies those flips);
             under the head policy, whose HiF4 head amplifies them further,
             at most 10%, printed beside the CPU's own share under a
             reordered attention, and the head must be bitwise equal card
             vs CPU on the card's final hidden state. Greedy tokens must
             agree, or differ only where the reference's top-2 logit gap is
             within that tolerance.
7. paged   — the paged path at full width on the first 4 of 24 layers
             (a cut for time): 12 requests sharing a
             256-token prefix through 8 slots and a 24-page HiF4 pool
             (P=64, 32 new tokens, decode chunk 8), which shows shared-prefix
             hits, a COW copy, LRU evictions and a preemption; every
             request's tokens must equal its solo serve at attn_kv_block=P,
             kernel 4 must launch exactly 12 x the decode steps and kernel 3
             never.
8. robust  — the same requests and pool, the weights on the first 2 of
             24 layers: a serving artifact saved
             (packed on the card) and loaded back onto it, serving the
             in-memory prepare's tokens, and one flipped byte raising
             ArtifactIntegrityError naming its leaf; GuardConfig() beside
             the unguarded run: the same tokens and launch
             counts, no more synchronize warnings under
             torch.cuda.set_sync_debug_mode("warn"), decode ms/step of
             each; page_corruption, code_flip (paged), nan_activation
             (slot scheduler, bf16 KV), pool_starvation and
             snapshot_truncation, each caught by the guard the reference
             names, on the first 2 layers at full width, survivors
             bitwise an uninjected run; crash_mid_decode with a pool
             checkpoint every chunk, resumed bitwise the guarded run, with
             the recovery report.
9. families — the dense and MoE configs beyond qwen1.5-0.5b, weights drawn
             on the card from --seed: kernel 2 at their new (K, N) in its
             decode route (the decode form; at nemotron-4-340b's FFN
             down-projection, K = 73 728, kernel 1 then kernel 2's __dp4a
             body) and its prefill form, bitwise its plain version, and
             kernels 3 and 4 at their new head layouts (rep 4 / D 128, rep
             12 / D 192, rep 2 / D 64), all timed; lockstep serves (paper-
             iv, impl packed, HiF4 KV, batch 8, prompt 480) at full width
             of qwen3-4b (12 of 36 layers) and
             granite-moe-1b-a400m on 6 of 24 (32 new tokens)
             and nemotron-4-340b on its first 2 of 96 layers
             (8 new tokens, the packing's peak memory), exact launches per
             kernel and shape, tokens that vary across the batch; granite
             (first 2 of 24 layers) through the paged phase's pool on
             prompts of 400-480 tokens (hits, COW, evictions, a
             preemption), paged equal to solo for requests 0-2 and every
             preempted one; granite's expert einsums'
             device time per step (repro_torch.launch.profile); granite on
             2 layers card (kernels) vs card (plain versions, bitwise
             prefill logits) vs CPU: at most 1% of the prefill logits
             outside rtol=0.05, atol=0.1, the routing flips counted.
10. ssm    — the Mamba2 SSM and hybrid families (prompt 512, a multiple of
             the SSD chunk): kernels 1, 2 and 5 at the shapes they give,
             each bitwise its plain version and timed (kernel 2 at mamba2's
             six linears, N 64 and 128 among them; kernel 5's tensor-core
             body and decode form at zamba2's dense linears, N 64 and 80
             among them); lockstep serves at full width, weights drawn on
             the card at 5x: mamba2-1.3b (16 of 48 layers, paper-iv, impl
             packed) and zamba2-2.7b (18 of 54 Mamba layers, 3 calls of the
             shared block, impl pallas, HiF4 KV narrowed to bf16 with one
             KVFallbackWarning), batch 8, 32 new tokens, exact launches per
             kernel and shape, tokens that vary, the first 4 steps against
             the plain versions; mamba2 on 2 layers card (kernels) vs card
             (plain versions, bitwise prefill logits) vs CPU: at most 1% of
             the prefill logits outside rtol=0.05, atol=0.1, tokens equal;
             mamba2's decode step profiled (repro_torch.launch.profile).
11. encdec — the audio encoder-decoder and the vlm backbone, weights drawn
             on the card at 5x, paper-iv, impl packed, HiF4 KV (whisper's
             self and read-only cross caches): kernels 1 and 2 at their new
             shapes (whisper's K 384 and 1 536 at 12 288 frame rows,
             llava's K 7 168 and 20 480 at 3 840), bitwise their plain
             versions, and kernel 3 at whisper's self (33 slots) and cross
             (1 536 frames) caches and llava's 56 heads on 8, all timed;
             lockstep serves at batch 8, 32 new tokens, of whisper-tiny at
             full width and depth (4 encoder and 4 decoder layers, 1 536
             frames, decoding from BOS) and llava-next-34b at full width on
             its first 4 of 60 layers (480-token embeds), exact launches per
             kernel and shape (kernel 3 per cache), tokens that vary, the
             first 4 steps against the plain versions; whisper at batch 2
             card (kernels) vs card (plain versions, bitwise prefill
             logits) vs CPU: at most 1% of the prefill logits outside
             rtol=0.05, atol=0.1 (init-scale weights, as every e2e cut;
             the 5x weights read, not bounded), tokens compared.
12. calibrate — calibration (which itself launches no kernel: the probe's
             bf16 forward has no plan, HiGPTQ and the scoring are plain
             PyTorch, as in the reference), then its policy served:
             (a) reduced qwen1.5-0.5b calibrated on the card and on the
             CPU, the same weights and batches, at the sensitive-fallback
             preset's bytes: the same assignment and bytes, every per-site
             error within rtol 2e-2, HiGPTQ within 1.25x the direct cast;
             (b) qwen1.5-0.5b at full width and depth (5x weights drawn on
             the card, 2 batches of (2, 64)) at that target and at 0.7
             B/value: the probe's, HiGPTQ's and the search's seconds, each
             site's hif4 and hif4_direct errors, the achieved B/value and
             both baselines; feasible, verified (calibrate raises
             otherwise), the curve's bytes falling strictly, the search at
             the preset's bytes no worse than the preset in bytes and
             error, a mixed plan; (c) the fallback target's emitted file
             through get_policy(path, impl="packed") with its HiF4 KV,
             served at batch 8, prompt 480, 32 new tokens: launches exact
             from the assignment (the bf16 sites take torch.matmul), the
             served in-budget bytes equal to the report's, the first 4
             tokens against the plain versions. Policy files and reports go
             to .calibrate/ in the checkout (git-ignored).
13. train  — training, which launches no kernel (impl qdq, as in the
             reference): (a) the flash attention autograd.Functions (scan_q
             and vec_q) against autograd of a naive f32 softmax attention at
             the train shape (B 8, S 128, H 16, D 64) and at S 512 with
             256-chunks, causal and not (f32 operands within atol 3e-5; bf16
             within 2^-7 of the largest gradient), and the vec_q backward's
             peak memory, also at B 2, S 4 096; (b) python -m repro_torch train at full
             width and depth (qwen1.5-0.5b, hif4, remat, batch 8, seq 128,
             16 steps, weights drawn on the card from --seed), in-process:
             finite losses, the last 4 below the first 4, zero kernel
             launches, median step ms, tokens/s and peak memory; (c) a
             1-layer full-width cut, one batch of (4, 128), one step on the
             card and on the CPU: the loss, every leaf's gradient and the
             updated params within stated tolerances; (d) the cut's run
             killed after step 3 (checkpoint at 2, git-ignored .train/) and
             resumed: its losses and final params equal the uninterrupted
             run's bitwise (the deterministic-algorithms warnings printed
             beside); (e) the cut trained TRAIN["trained_steps"] steps, its
             loss curve, and the card-vs-CPU share of its prefill logits
             beside the untrained cut's (printed, not bounded); (f) the
             five non-dense families (TRAIN_FAMILIES): one step card vs CPU
             of full-width cuts of granite-moe-1b-a400m, mamba2-1.3b and
             zamba2-2.7b (1 layer each, zamba2's shared block once, after
             it) and whisper-tiny (2 + 2, seeded frames) within
             TRAIN_CUT_TOL (zamba2 within TRAIN_FAMILY_TOL); python
             -m repro_torch train --layers N for granite, mamba2 and zamba2
             (median step ms, tokens/s, peak memory); their cuts killed and
             resumed bitwise, as (d); llava-next-34b's 2-layer full-width
             cut trained 4 steps on the card (time, peak memory) and its
             reduced config card vs CPU.

14. dryrun — the dry run (repro_torch.launch.dryrun, on meta on this
             machine's CPU) held against real runs of the same steps at full
             width on the card, weights drawn on the card from --seed:
             qwen1.5-0.5b train_4k (batch 256 cut to 2, 6 of 24 layers,
             impl qdq, remat, one step), prefill_32k (batch 32 cut to 1, 4
             of 24 layers) and decode_32k (batch 128 cut to 8, all 24
             layers, a 24 GiB bf16 cache),
             zamba2-2.7b and mamba2-1.3b long_500k (batch 1, no cut): the
             residency exactly the bytes of the tensors the card run
             allocates, peak_bytes_est within 10% of
             torch.cuda.max_memory_allocated(), the matmul FLOPs equal to a
             FlopCounterMode count of the card run, the step time printed
             beside max(t_compute, t_memory) (a reading, no bound); then the
             serving route at the assignment's shapes (paper-iv, impl packed,
             HiF4 KV): a 32 768-token qwen1.5-0.5b prefill (6 of 24
             layers) at batch 1 and one
             decode step from its cache, exact launches, prefill logits
             bitwise and greedy tokens equal to the plain versions' run,
             kernels 1 and 2 (M = 32 768) bitwise and kernel 3 (S = 32 770)
             within rtol 2^-7, atol 1e-3 and a relative norm of 1e-3 of
             their plain versions on layer 0's operands, each timed (kernel
             3 beside SDPA on the dequantized K/V).
15. scenario — the serve-cell harness (repro_torch.runtime.scenario.
             run_scenarios) at full width, weights from --seed, repeats 3,
             the gate pairs qwen-packed-hif4 / its guarded twin and
             qwen-packed-bf16 / qwen-packed-hif4 (the reference's gate
             hif4_over_bf16_kv_decode: bf16 ms / HiF4 ms printed beside its
             0.9 limit, not asserted): qwen1.5-0.5b
             (batch 8, prompt 480, 8 tokens) packed HiF4, guarded, bf16 KV,
             qdq, paged (16-token pages) and paged with the journal and a
             crash; whisper-tiny (1 536 frames) and mamba2-1.3b (prompt
             512). Every probed dispatch holds and agrees with the kernels
             each cell's decode launched (kernel 3 in the HiF4 scan cells
             only, kernel 4 at P = 16 in the paged ones only, kernel 2's
             decode form in every packed cell, nothing in the qdq cell; one
             KV append a layer a step on every HiF4 cache, none on bf16);
             kernel 4 on a paged cell's pool and kernel 3 past the cache's
             capacity (the timing loop decodes beyond it; writes clamp at
             the last slot) within rtol 2^-7, atol 1e-3 of their plain
             versions; recovery bitwise; no decode step below its bytes
             over the card's memory rate. One JSON line per cell (decode
             and prefill ms, the four byte counts, that bound, its share).
16. examples — the four examples (examples/torch_*.py) in process on the
             card: the quickstart's tour (the fixed-point dot equal to the
             dequantized one; its matmul, kernel 1 then kernel 5's decode
             form at M = 32, one launch each, bitwise its plain versions on
             the card and on the CPU, kernel 5's decode form timed at that
             shape); the PTQ walkthrough (HiGPTQ below the direct cast, its
             error card vs CPU within PTQ_CARD_REL); the serve example's
             main at its defaults (reduced qwen1.5-0.5b trained 120 steps on
             the card, 16 tokens: bf16 100.0%, every qdq row launching
             nothing, every packed row kernel 1 and kernel 2 in both forms
             at 0.5625 B/value, the HiF4-KV row kernel 3 and the KV append
             once a layer a step, the cache's bytes a token equal to the
             row's, each packed row's tokens against serve_table on the CPU
             on the same card-trained params), then its main for reduced
             qwen1.5-4b and phi3.5-moe-42b-a6.6b; the train example's two
             runs (qwen3-4b reduced, 60 steps each, into a fresh
             .train/examples/): falling losses, the step-50 checkpoint, no
             kernel launch.

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
import math
import os
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
# distinct input copies a timing loop cycles through (> the 50 MB L2)
L2_ROTATION = 24
# qwen1.5-0.5b's tied embedding (vocab, d_model): the pallas LM head's weight
EMBED_SHAPE = (151936, 1024)
# qwen1.5-0.5b's quantized linears (K, N): wq wk wv wo, wg wu, the MLP's wo;
# and how many of a layer's 7 linears take each; the prefill's rows (batch 8
# x prompt 480)
DECODE_SHAPES = ((1024, 1024), (1024, 2816), (2816, 1024))
DECODE_SITES = {(1024, 1024): 4, (1024, 2816): 2, (2816, 1024): 1}
PREFILL_M = 3840


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


def device_ms(fn, args_list, iters: int = 100, replays: int = 5) -> float:
    """Mean device ms per call: the same rotating calls as :func:`cuda_ms`,
    captured in one CUDA graph whose replays are timed with events, so the
    window holds no host work. The warm-up before the capture does the lazy
    module loading, the library load and any shared-memory attribute; the
    launch counters count the capture, not the replays (callers reset them
    before the runs they check)."""
    import torch

    for i in range(3):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def host_us(fn, args_list, iters: int = 200) -> float:
    """Mean host microseconds per wrapper call: a host clock around many
    calls with no synchronize inside the window (the device's queue holds
    them; where the device is the slower side the queue fills and this
    reads the device instead)."""
    import torch

    for i in range(3):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / iters


def timed(fn, args_list, iters: int = 200) -> dict:
    """kernel_ms (events around the eager loop: host dispatch included where
    the host is the slower side), device_ms (graph replay) and host_us."""
    return {"ms": cuda_ms(fn, args_list, iters=iters),
            "device_ms": device_ms(fn, args_list, iters=min(iters, 100)),
            "host_us": host_us(fn, args_list, iters=iters)}


def _times(t: dict) -> str:
    return (f"kernel_ms={t['ms']:.6f} device_ms={t['device_ms']:.6f} "
            f"host_us={t['host_us']:.2f}")


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
    t = timed(hif4_quantize, [(x,) for x in xs])
    plain_ms = cuda_ms(absorbed_activation, [(x,) for x in xs], iters=50)
    bound_ms = _quantize_bound_ms(m, k)
    print(f"  hif4_quantize decode (8, 1024) bf16 (the parent's decode path; "
          f"now prefill and the pallas head only): {_times(t)} "
          f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} (bytes) "
          f"library_ms=n/a (no single PyTorch call)")
    # the prefill activations of the main path (batch 8 x prompt 480)
    m, k = 3840, 1024
    xs = [torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev)
          for _ in range(L2_ROTATION)]       # 24 x 7.9 MB > the 50 MB L2
    p_t = timed(hif4_quantize, [(x,) for x in xs], iters=100)
    p_plain_ms = cuda_ms(absorbed_activation, [(x,) for x in xs], iters=10,
                         warmup=1)
    p_bound_ms = _quantize_bound_ms(m, k)
    print(f"  hif4_quantize prefill (3840, 1024) bf16: {_times(p_t)} "
          f"plain_ms={p_plain_ms:.5f} bound_ms={p_bound_ms:.6f} (bytes)")
    del xs
    # the pallas LM head quantizes the whole tied embedding on every call
    m, k = EMBED_SHAPE
    dg = torch.Generator(device=dev).manual_seed(16)
    embeds = [(torch.randn(m, k, generator=dg, device=dev) * 0.02).to(torch.bfloat16)
              for _ in range(2)]                   # 2 x 311 MB > the 50 MB L2
    ki, ks = hif4_quantize(embeds[0])
    rows = slice(0, 8192)
    pi, ps = absorbed_activation(embeds[0][rows])
    torch.cuda.synchronize()
    check(torch.equal(ki[rows], pi) and torch.equal(ks[rows].view(torch.int32),
                                                    ps.view(torch.int32)),
          "hif4_quantize on the embedding: rows 0-8191 differ from the plain version")
    del ki, ks, pi, ps
    e_t = timed(hif4_quantize, [(e,) for e in embeds], iters=20)
    e_plain_ms = cuda_ms(absorbed_activation, [(e,) for e in embeds], iters=3,
                         warmup=1)
    e_bytes = m * k * 2 + m * k + m * (k // 64) * 4
    e_bound_ms = _quantize_bound_ms(m, k)
    print(f"  hif4_quantize embedding ({m}, {k}) bf16: rows 0-8191 bitwise equal "
          f"to the plain version; {_times(e_t)} plain_ms={e_plain_ms:.5f} "
          f"bound_ms={e_bound_ms:.6f} (bytes: {e_bytes} B)")
    # the row is the main path's shape: kernel 1 launches only on the
    # prefill activations there (the decode form quantizes in its prologue)
    records["hif4_quantize"] = {
        "name": "hif4_quantize", "route": "cuda",
        "source": "src/repro_torch/csrc/hif4_quant.cu",
        "replaces": "src/repro/kernels/hif4_quant.py:75",
        "max_abs_err": worst, **p_t, "plain_ms": p_plain_ms,
        "bound_ms": p_bound_ms, "bound_by": "bytes", "library_ms": None,
        "shape": "x (3840, 1024) bf16 (prefill)",
        "decode": {"shape": "x (8, 1024) bf16", **t, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes",
                   "launches": 0},
        "embedding": {"shape": f"x ({m}, {k}) bf16", **e_t,
                      "plain_ms": e_plain_ms, "bound_ms": e_bound_ms,
                      "bound_by": "bytes"}}


def _quantize_bound_ms(m, k):
    """bf16 in, int8 ints and f32 scales out, each byte once; 16 f32 ops per
    value (a lower estimate)."""
    nbytes = m * k * 2 + m * k + m * (k // 64) * 4
    return max(nbytes / HBM_BYTES_PER_S, 16 * m * k / F32_FLOPS_PER_S) * 1e3


def check_matmul(dev, records):
    """Kernel 2 called directly: bitwise equal to its plain version (kernel
    5's on the expanded weight, then the cast) in f32 and bf16 out at the
    three linear shapes for M in {8, 33, 300, 3840} (M > 32: the tensor-core
    body) and at a ragged shape (N % 16 != 0, K/64 = 5); a NaN meta word
    confined to its column; then the prefill form timed at the main path's
    three prefill shapes (M = 3840 = batch 8 x prompt 480, bf16 out as the
    engine asks), launch-weighted 4 : 2 : 1 as a layer's linears take them."""
    import torch
    from repro_torch.core import hif4
    from repro_torch.core.qlinear import PackedW
    from repro_torch.kernels.fused_matmul import (
        fused_packed_matmul, fused_packed_matmul_plain)
    from repro_torch.kernels.hif4_quant import absorbed_activation

    gen = torch.Generator().manual_seed(12)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    worst, cases = 0.0, 0
    for k, n in DECODE_SHAPES + ((320, 1000),):
        w = (torch.randn(k, n, generator=gen) * 0.02).to(torch.bfloat16).to(dev)
        codes, meta = PackedW.from_dense(w).to_kernel_layout().kernel_operands()
        for m in (8, 33, 300, 3840):
            x = torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev)
            ai, asc = absorbed_activation(x)
            for label, dt in dts.items():
                y = fused_packed_matmul(ai, asc, codes, meta, dt)
                ref = fused_packed_matmul_plain(ai, asc, codes, meta, dt)
                torch.cuda.synchronize()
                worst = max(worst, float((y.float() - ref.float()).abs().max()))
                check(torch.equal(bits(y), bits(ref)),
                      f"fused_packed_matmul M={m} K={k} N={n} {label}: not "
                      f"bitwise equal to the plain version at "
                      f"{int((bits(y) != bits(ref)).sum())} outputs")
                cases += 1
        print(f"  fused_packed_matmul K={k} N={n}: bitwise equal to the plain "
              f"version at M 8, 33, 300, 3840, f32 and bf16 out")
    w = (torch.randn(1024, 1000, generator=gen) * 0.02).to(torch.bfloat16).to(dev)
    codes, meta = PackedW.from_dense(w).to_kernel_layout().kernel_operands()
    meta = meta.clone()
    meta[5, 997] |= -(1 << 24)                        # E6M2 code 0xFF
    for m in (8, 300):
        ai, asc = absorbed_activation(
            torch.randn(m, 1024, generator=gen).to(torch.bfloat16).to(dev))
        y = fused_packed_matmul(ai, asc, codes, meta)
        want = torch.zeros_like(y, dtype=torch.bool)
        want[:, 997] = True
        torch.cuda.synchronize()
        check(torch.equal(y.isnan(), want), f"fused_packed_matmul M={m}: a NaN "
              f"meta word reached outputs outside its column")
    print(f"  fused_packed_matmul: {cases} cases bitwise; NaN meta -> its column "
          f"only (M 8 and 300)")

    def prefill(ai, asc, codes, meta):
        return fused_packed_matmul(ai, asc, codes, meta, torch.bfloat16)

    def plain(ai, asc, codes, meta):
        return fused_packed_matmul_plain(ai, asc, codes, meta, torch.bfloat16)

    m, shapes = PREFILL_M, []
    for k, n in DECODE_SHAPES:
        copies = []
        for _ in range(8):           # 8 x (3.9 MB of ints + the weight) > L2
            w = (torch.randn(k, n, generator=gen) * 0.02).to(torch.bfloat16).to(dev)
            codes, meta = PackedW.from_dense(w).to_kernel_layout().kernel_operands()
            x = torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev)
            ai, asc = absorbed_activation(x)
            b_nk = hif4.absorbed_int_km(codes, meta)[0].T.contiguous()
            copies.append(((ai, asc, codes, meta), (x, w), (ai, b_nk.T)))
        t = timed(prefill, [c[0] for c in copies], iters=60)
        plain_ms = cuda_ms(plain, [c[0] for c in copies], iters=3, warmup=1)
        library_ms = cuda_ms(torch.matmul, [c[1] for c in copies], iters=60)
        try:
            int_mm_ms = cuda_ms(torch._int_mm, [c[2] for c in copies], iters=60)
        except RuntimeError as e:        # a yardstick only: note a refusal
            int_mm_ms = None
            print(f"  torch._int_mm refused ({str(e).splitlines()[0]})")
        bound_ms, bound_by, nbytes = _prefill_bound_ms(m, k, n)
        floor_ms = _promotion_floor_ms(m, k, n)
        print(f"  fused_packed_matmul prefill form M={m} K={k} N={n} bf16: "
              f"{_times(t)} plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} "
              f"({bound_by}: {nbytes} B) promotion floor {floor_ms:.6f} ms; "
              f"library_ms={library_ms:.5f} (torch.matmul bf16 dense), "
              f"torch._int_mm {int_mm_ms} ms (int8, no group scales): neither "
              f"the same function")
        shapes.append({"shape": f"M={m} K={k} N={n} bf16", "k_n": (k, n), **t,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms,
                       "int_mm_ms": int_mm_ms})
        del copies
    # the row: means over the three prefill shapes weighted by their launches
    # (4 : 2 : 1 per layer, 96 : 48 : 24 per serve run), so that launches x
    # (ms - bound_ms) is the main path's total; phase serve sets each shape's
    # launches from the wrapper's count per shape
    sites = [DECODE_SITES[tuple(sh["k_n"])] for sh in shapes]

    def mean(key):
        vals = [sh[key] for sh in shapes]
        return None if None in vals else sum(
            w * v for w, v in zip(sites, vals)) / sum(sites)

    records["fused_packed_matmul"] = {
        "name": "fused_packed_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_matmul.cu",
        "body": "src/repro_torch/csrc/group_matmul_sm90.cuh",
        "replaces": "src/repro/kernels/fused_matmul.py:65",
        "max_abs_err": worst, **{key: mean(key) for key in (
            "ms", "device_ms", "host_us", "plain_ms", "bound_ms",
            "library_ms", "int_mm_ms")},
        "bound_by": "bytes" if all(sh["bound_by"] == "bytes" for sh in shapes)
        else "operations",
        "library": "torch.matmul bf16 dense (M,K)x(K,N); int_mm_ms: "
                   "torch._int_mm int8 (M,K)x(K,N) without group scales; "
                   "neither the same function",
        "shape": f"M={m} bf16 out at (K, N) (1024, 1024), (1024, 2816), "
                 f"(2816, 1024), launch-weighted 4:2:1 (prefill form)",
        "shapes": shapes}


def _prefill_bound_ms(m, k, n, out_bytes=2):
    """The int8 activations and their scales, the packed weight (codes +
    meta words) read and the output written once each; 2 M N K int8
    operations."""
    nbytes = (m * k + m * (k // 64) * 4 + k * n // 2 + (k // 64) * n * 4
              + m * n * out_bytes)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / INT8_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations"), nbytes


def _promotion_floor_ms(m, k, n):
    """A note printed beside the roofline (not a field of the kernel
    records): the group-scaled sum's own CUDA-core floor. Every (row, column, 64-group) takes a subtract (the exact
    float of its int32 dot), two multiplies and an add, each rounded alone;
    at the f32 peak (67 TFLOP/s counts a fused multiply-add as two) that is
    33.5 T such instructions a second."""
    return m * n * (k // 64) * 4 / (F32_FLOPS_PER_S / 2) * 1e3




def _decode_bound_ms(m, k, n, x_bytes=2, out_bytes=2):
    """x read, the packed weight (codes + meta words) read and the output
    written once each; 2 M N K int8 operations."""
    nbytes = m * k * x_bytes + k * n // 2 + (k // 64) * n * 4 + m * n * out_bytes
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / INT8_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations"), nbytes


def check_decode_matmul(dev, records):
    """The decode form of kernel 2 with kernel 1 as its prologue: bitwise
    equal to its plain version (the pair, then the cast) at the three decode
    shapes, M in {1, 8, 16, 32}, bf16 and f32 in and out, and at a ragged
    shape; bitwise equal to kernel 5 on packed_to_absorbed(pw) fed kernel
    1's ints; a NaN meta word confined to its column; then timed at M=8
    bf16 (the main path) beside the pair it replaces (kernel 1, kernel 2,
    the cast), and at M=32 K=2816 (the largest prologue)."""
    import torch
    from repro_torch.core.engine import packed_to_absorbed
    from repro_torch.core.qlinear import PackedW
    from repro_torch.kernels.bfp_matmul import bfp_matmul_quantized
    from repro_torch.kernels.fused_matmul import (
        decode_plan, fused_decode_matmul, fused_decode_matmul_plain,
        fused_packed_matmul)
    from repro_torch.kernels.hif4_quant import hif4_quantize

    gen = torch.Generator(device=dev).manual_seed(18)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    def packed(k, n):
        w = (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        return PackedW.from_dense(w).to_kernel_layout(), w

    cases, worst = 0, 0.0
    for k, n in DECODE_SHAPES + ((320, 1000), (1024, 1040)):
        pw, _ = packed(k, n)
        for m in (1, 8, 16, 32):
            xf = torch.randn(m, k, generator=gen, device=dev) * torch.exp2(
                torch.empty(m, k // 64, 1, device=dev).uniform_(
                    -10, 10, generator=gen)).repeat_interleave(64, 1).reshape(m, k)
            for din, dout in ((a, b) for a in dts for b in dts):
                x = xf.to(dts[din])
                y = fused_decode_matmul(x, pw.codes, pw.meta, dts[dout])
                ref = fused_decode_matmul_plain(x, pw.codes, pw.meta, dts[dout])
                torch.cuda.synchronize()
                worst = max(worst, float((y.float() - ref.float()).abs().max()))
                check(torch.equal(bits(y), bits(ref)),
                      f"fused_decode_matmul M={m} K={k} N={n} {din}->{dout}: not "
                      f"bitwise equal to the plain version at "
                      f"{int((bits(y) != bits(ref)).sum())} outputs")
                cases += 1
        x = torch.randn(8, k, generator=gen, device=dev).to(torch.bfloat16)
        y = fused_decode_matmul(x, pw.codes, pw.meta, torch.float32)
        ai, asc = hif4_quantize(x)
        y5 = bfp_matmul_quantized(ai, asc, *packed_to_absorbed(pw))
        torch.cuda.synchronize()
        check(torch.equal(bits(y), bits(y5)), f"fused_decode_matmul K={k} N={n}: "
              f"not bitwise equal to bfp_matmul_quantized on packed_to_absorbed")
        plan = decode_plan(8, k, n)
        print(f"  fused_decode_matmul K={k} N={n}: bitwise equal to the plain "
              f"version (M 1, 8, 16, 32; bf16/f32 in and out) and to "
              f"bfp_matmul_quantized on packed_to_absorbed; plan at M=8: "
              f"{plan.grid} CTAs in clusters of {plan.split}, "
              f"{plan.smem_bytes} B shared")
    pw, _ = packed(1024, 1000)
    meta = pw.meta.clone()
    meta[5, 997] |= -(1 << 24)                        # E6M2 code 0xFF
    x = torch.randn(8, 1024, generator=gen, device=dev).to(torch.bfloat16)
    y = fused_decode_matmul(x, pw.codes, meta)
    want = torch.zeros_like(y, dtype=torch.bool)
    want[:, 997] = True
    torch.cuda.synchronize()
    check(torch.equal(y.isnan(), want), "fused_decode_matmul: a NaN meta word "
          "reached outputs outside its column")
    print(f"  fused_decode_matmul: {cases} cases bitwise; NaN meta -> its "
          f"column only")

    def pair(x, codes, meta):
        return fused_packed_matmul(*hif4_quantize(x), codes, meta).to(x.dtype)

    shapes = []
    for m, k, n in [(8, k, n) for k, n in DECODE_SHAPES] + [(32, 2816, 1024)]:
        rot = -(-60 * 2 ** 20 // (k * n * 9 // 16))  # packed copies > 50 MB L2
        ws = [packed(k, n) for _ in range(rot)]
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        args = [(x, pw.codes, pw.meta) for pw, _ in ws]
        t = timed(fused_decode_matmul, args)
        old = timed(pair, args)
        plain_ms = cuda_ms(fused_decode_matmul_plain, args, iters=10, warmup=1)
        library_ms = cuda_ms(torch.matmul, [(x, w) for _, w in ws], iters=200)
        bound_ms, bound_by, nbytes = _decode_bound_ms(m, k, n)
        plan = decode_plan(m, k, n)
        print(f"  fused_decode_matmul M={m} K={k} N={n} bf16: {_times(t)} "
              f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by}: "
              f"{nbytes} B) library_ms={library_ms:.5f} (torch.matmul bf16 "
              f"dense, not the same function); the pair it replaces (kernel 1, "
              f"kernel 2, cast): {_times(old)}; {plan.grid} CTAs")
        shapes.append({"shape": f"M={m} K={k} N={n} bf16", "k_n": (k, n),
                       **t, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms,
                       "pair": old, "ctas": plan.grid, "split": plan.split})
        del ws, args
    # the row: means over the main path's three shapes at M=8, weighted by
    # their launches (4 : 2 : 1 per layer), so that launches x (ms -
    # bound_ms) is the main path's total; phase serve adds each shape's
    # launches
    sites = [DECODE_SITES[tuple(sh["k_n"])] for sh in shapes[:3]]
    records["fused_decode_matmul"] = {
        "name": "fused_decode_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_decode_matmul.cu",
        "replaces": "src/repro/kernels/fused_matmul.py:65",
        "prologue_replaces": "src/repro/kernels/hif4_quant.py:75",
        "max_abs_err": worst, **{key: sum(w * sh[key] for w, sh in zip(
            sites, shapes)) / sum(sites) for key in (
            "ms", "device_ms", "host_us", "plain_ms", "bound_ms",
            "library_ms")},
        "bound_by": "bytes" if all(sh["bound_by"] == "bytes"
                                   for sh in shapes[:3]) else "operations",
        "library": "torch.matmul bf16 dense (M,K)x(K,N), not the same function",
        "shape": "M=8 bf16 at (K, N) (1024, 1024), (1024, 2816), (2816, "
                 "1024), launch-weighted 4:2:1", "shapes": shapes}


def _lm_head_operands(m, k, n, gen, dev):
    """Kernel 5's operands as the pallas LM head makes them: kernel 1 on the
    activations (M, K) and on the weight stored (N, K), the weight's ints
    and scales handed over as transposed views (K-contiguous columns)."""
    import torch
    from repro_torch.kernels.hif4_quant import hif4_quantize

    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(n, k, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    ai, asc = hif4_quantize(x)
    wi, wsc = hif4_quantize(w)
    return ai, asc, wi.T, wsc.T, x, w


def _group_matmul_bound_ms(m, k, n):
    """Each int8 input and f32 scale read once, the (M, N) f32 output
    written once; 2 M N K int8 operations."""
    nbytes = (m * k + m * (k // 64) * 4 + k * n + (k // 64) * n * 4
              + m * n * 4)
    ops = 2 * m * n * k
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations"), nbytes


def check_bfp_matmul(dev, records):
    """Kernel 5 bitwise equal to its plain version at the LM head's decode
    shape, ragged decode shapes (M 1, 17, 32), the prefill shape, the
    tensor-core body's first M and a ragged prefill shape; bitwise against
    kernel 2 on the absorbed expansion of a packed weight at M 1, 8, 32
    (the decode body) and 33, 300, 3840; a NaN scale confined to its row
    and column in either body; then timed at the LM head's shape and the
    prefill shape."""
    import torch
    from repro_torch.core.engine import packed_to_absorbed
    from repro_torch.core.qlinear import PackedW
    from repro_torch.kernels.bfp_matmul import (
        bfp_matmul_quantized, bfp_matmul_quantized_plain)
    from repro_torch.kernels.fused_matmul import fused_packed_matmul
    from repro_torch.kernels.hif4_quant import hif4_quantize

    gen = torch.Generator(device=dev).manual_seed(17)
    vocab, d = EMBED_SHAPE
    worst = 0.0
    for m, k, n, label in ((8, d, vocab, "LM head decode"),
                           (1, 320, 1001, "one row, ragged N, K/64 = 5"),
                           (17, 320, 1001, "24 row slots, ragged N"),
                           (32, 1024, 1000, "the decode body's last M"),
                           (3840, 1024, 2816, "prefill"),
                           (33, 1024, 1024, "the tensor-core body's first M"),
                           (37, 320, 1000, "ragged: M, N tails, K/64 = 5")):
        ai, asc, bi, bsc, _, _ = _lm_head_operands(m, k, n, gen, dev)
        y = bfp_matmul_quantized(ai, asc, bi, bsc)
        ref = bfp_matmul_quantized_plain(ai, asc, bi, bsc)
        torch.cuda.synchronize()
        err = (y - ref).abs()
        worst = max(worst, float(err.max()))
        check(torch.equal(y.view(torch.int32), ref.view(torch.int32)),
              f"bfp_matmul_quantized M={m} K={k} N={n}: not bitwise equal to "
              f"the plain version (max |d| {float(err.max())})")
        print(f"  bfp_matmul_quantized {label} M={m} K={k} N={n}: bitwise "
              f"equal to the plain version")
    for m in (1, 8, 32, 33, 300, 3840):
        w = (torch.randn(1024, 2816, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        pw = PackedW.from_dense(w).to_kernel_layout()
        x = torch.randn(m, 1024, generator=gen, device=dev).to(torch.bfloat16)
        ai, asc = hif4_quantize(x)
        y5 = bfp_matmul_quantized(ai, asc, *packed_to_absorbed(pw))
        y2 = fused_packed_matmul(ai, asc, pw.codes, pw.meta)
        torch.cuda.synchronize()
        check(torch.equal(y5.view(torch.int32), y2.view(torch.int32)),
              f"bfp_matmul_quantized on packed_to_absorbed(pw), M={m}: not "
              f"bitwise equal to fused_packed_matmul on pw")
        print(f"  bfp_matmul_quantized on packed_to_absorbed(pw) M={m} K=1024 "
              f"N=2816: bitwise equal to fused_packed_matmul on pw")
    for m in (8, 300):
        ai, asc, bi, bsc, _, _ = _lm_head_operands(m, 256, 200, gen, dev)
        asc[3, 2] = float("nan")
        bsc[1, 130] = float("nan")
        y = bfp_matmul_quantized(ai, asc, bi, bsc)
        want = torch.zeros_like(y, dtype=torch.bool)
        want[3, :] = True
        want[:, 130] = True
        torch.cuda.synchronize()
        check(torch.equal(y.isnan(), want), f"bfp_matmul_quantized M={m}: a "
              f"NaN scale reached outputs outside its row and column")
    print("  bfp_matmul_quantized: NaN a_scale -> its row only, NaN b_scale -> "
          "its column only (M 8 and 300)")

    rows = {}
    for m, k, n, copies in ((8, d, vocab, 3), (3840, 1024, 2816, 8)):
        ops = [_lm_head_operands(m, k, n, gen, dev) for _ in range(copies)]
        args = [o[:4] for o in ops]
        t = timed(bfp_matmul_quantized, args, iters=30)
        plain_ms = cuda_ms(bfp_matmul_quantized_plain, args, iters=5, warmup=1)
        library_ms = cuda_ms(torch.matmul, [(o[4], o[5].T) for o in ops], iters=30)
        bound_ms, bound_by, nbytes = _group_matmul_bound_ms(m, k, n)
        rows[m] = dict(t, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
        floor = (f" promotion floor {_promotion_floor_ms(m, k, n):.6f} ms"
                 if m > 32 else "")
        print(f"  bfp_matmul_quantized M={m} K={k} N={n}: {_times(t)} "
              f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by}: "
              f"{nbytes} B){floor} library_ms={library_ms:.5f} (torch.matmul "
              f"bf16 dense, not the same function)")
        del ops, args
    records["bfp_matmul_quantized"] = {
        "name": "bfp_matmul_quantized", "route": "cuda",
        "source": "src/repro_torch/csrc/bfp_matmul.cu",
        "replaces": "src/repro/kernels/bfp_matmul.py:101",
        "max_abs_err": worst, **rows[8],
        "library": "torch.matmul bf16 dense (M,K)x(K,N), not the same function",
        "shape": f"M=8 K={d} N={vocab} (the pallas LM head)",
        "prefill": {"shape": "M=3840 K=1024 N=2816", **rows[3840]}}


def _sass_instructions(lib: str, *needles: str) -> int:
    """SASS instructions (NOPs aside) of the one function of a built library
    whose name holds every needle (``cuobjdump -sass``), up to its last
    EXIT: the slow-path subroutines placed after the body (a correctly
    rounded reciprocal's) are left out."""
    from repro_torch.kernels import build

    sass = subprocess.run(
        [str(Path(build.nvcc()).parent / "cuobjdump"), "-sass",
         str(build._target(lib))], capture_output=True, text=True,
        check=True).stdout
    bodies, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            bodies[name] = []
        elif name and line.strip().startswith("/*") and ";" in line \
                and " NOP" not in line:
            bodies[name].append(line)
    found = [n for n in bodies if all(nd in n for nd in needles)]
    check(len(found) == 1, f"cuobjdump -sass of {lib}: functions {found} "
          f"match {needles}")
    body = bodies[found[0]]
    exits = [i for i, line in enumerate(body) if " EXIT" in line]
    check(bool(exits), f"cuobjdump -sass of {lib}: no EXIT in {found[0]}")
    return exits[-1] + 1


def _issue_floor_ms(n_lanes: int, per_lane: int) -> float:
    """A note printed beside the roofline (not a field of the kernel
    records): ``per_lane`` instructions on each of ``n_lanes`` lanes, issued
    by 4 schedulers per SM (one warp instruction each per clock) on 132 SMs
    at the 1.98 GHz boost clock of the f32 peak."""
    return n_lanes / 32 * per_lane / (132 * 4 * 1.98e9) * 1e3


def _head_decode_bound_ms(m, k, n, w_bytes=2):
    """The decode form: the int8 activations and their scales and the
    weight read once, the (M, N) f32 output written once; 2 M N K int8
    operations."""
    nbytes = m * k + m * (k // 64) * 4 + k * n * w_bytes + m * n * 4
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / INT8_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations"), nbytes


def check_head_matmul(dev, records):
    """The decode form of kernel 5 (the weight's Algorithm 1 in its loader):
    bitwise equal to its plain version and to kernel 1 on w.T then kernel 5
    at the LM head's shape, at granite-moe-1b-a400m's tied head (N 49 155,
    odd, not a multiple of the 32-column tile) and at ragged shapes (M 1,
    8, 17, 32; K/64 = 5; N % 2 != 0), bf16 and f32 weights handed over as
    transposed views; a
    NaN weight confined to its column; then timed at the LM head's shape
    (M=8, K=1024, N=151 936, bf16) beside the pair it replaces (kernel 1 on
    the embedding, then kernel 5), with the bytes bound and Algorithm 1's
    issue floor (kernel 1's SASS instructions per lane, cuobjdump)."""
    import torch
    from repro_torch.kernels.bfp_matmul import (
        bfp_decode_matmul, bfp_decode_matmul_plain, bfp_matmul_quantized,
        decode_matmul_plan)
    from repro_torch.kernels.hif4_quant import hif4_quantize

    gen = torch.Generator(device=dev).manual_seed(19)
    vocab, d = EMBED_SHAPE
    worst, cases = 0.0, 0
    shapes = [(8, d, vocab, torch.bfloat16, "LM head"),
              (8, d, vocab, torch.float32, "LM head, f32 weight"),
              (8, d, 49155, torch.bfloat16, "granite-moe-1b-a400m's tied head")]
    shapes += [(m, k, n, dt, "ragged") for m in (1, 8, 17, 32)
               for k, n in ((320, 1001), (1024, 1000))
               for dt in (torch.bfloat16, torch.float32)]
    for m, k, n, dt, label in shapes:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        embed = (torch.randn(n, k, generator=gen, device=dev) * 0.02).to(dt)
        ai, asc = hif4_quantize(x)
        y = bfp_decode_matmul(ai, asc, embed.T)
        ref = bfp_decode_matmul_plain(ai, asc, embed.T)
        wi, wsc = hif4_quantize(embed)
        y5 = bfp_matmul_quantized(ai, asc, wi.T, wsc.T)
        torch.cuda.synchronize()
        worst = max(worst, float((y - ref).abs().max()))
        check(torch.equal(y.view(torch.int32), ref.view(torch.int32))
              and torch.equal(y.view(torch.int32), y5.view(torch.int32)),
              f"bfp_decode_matmul M={m} K={k} N={n} {dt}: not bitwise equal to "
              f"its plain version or to kernel 1 then kernel 5 at "
              f"{int((y != ref).sum())} / {int((y != y5).sum())} outputs")
        cases += 1
        if label != "ragged":
            print(f"  bfp_decode_matmul {label} M={m} K={k} N={n}: bitwise equal "
                  f"to the plain version and to kernel 1 then kernel 5")
    embed = (torch.randn(1000, 256, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    embed[997, 70] = float("nan")
    ai, asc = hif4_quantize(torch.randn(8, 256, generator=gen, device=dev))
    y = bfp_decode_matmul(ai, asc, embed.T)
    want = torch.zeros_like(y, dtype=torch.bool)
    want[:, 997] = True
    torch.cuda.synchronize()
    check(torch.equal(y.isnan(), want), "bfp_decode_matmul: a NaN weight "
          "reached outputs outside its column")
    print(f"  bfp_decode_matmul: {cases} cases bitwise (M 1, 8, 17, 32; K 320, "
          f"1024; bf16 and f32 weights; N 151 936, 49 155, 1 001, 1 000); NaN "
          f"weight -> its column only")

    # timed at the LM head, the pair it replaces in the same call
    m, k, n = 8, d, vocab
    ops = []
    for _ in range(2):                   # 2 x 311 MB of embedding > the L2
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        embed = (torch.randn(n, k, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        ops.append((*hif4_quantize(x), embed.T, x))

    def pair(ai, asc, w):
        wi, wsc = hif4_quantize(w.T)
        return bfp_matmul_quantized(ai, asc, wi.T, wsc.T)

    args = [o[:3] for o in ops]
    t = timed(bfp_decode_matmul, args, iters=30)
    old = timed(pair, args, iters=30)
    plain_ms = cuda_ms(bfp_decode_matmul_plain, args, iters=3, warmup=1)
    library_ms = cuda_ms(torch.matmul, [(o[3], o[2]) for o in ops], iters=30)
    bound_ms, bound_by, nbytes = _head_decode_bound_ms(m, k, n)
    per_lane = _sass_instructions("hif4_quant", "hif4_quantize_kernel",
                                  "nv_bfloat16", "Lb1E")
    floor_ms = _issue_floor_ms(n * k // 8, per_lane)
    pair_bound = (_quantize_bound_ms(n, k) + _group_matmul_bound_ms(m, k, n)[0])
    plan = decode_matmul_plan(m, k, n, "bf16")
    print(f"  bfp_decode_matmul M={m} K={k} N={n} bf16 (the LM head): "
          f"{_times(t)} plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} "
          f"({bound_by}: {nbytes} B); Algorithm 1 issue floor "
          f"{floor_ms:.6f} ms ({per_lane} SASS instructions per lane in kernel "
          f"1's body, load and store included, {n * k // 8} lanes); "
          f"library_ms={library_ms:.5f} (torch.matmul "
          f"bf16 dense, not the same function); plan {plan}")
    print(f"  the pair it replaces (kernel 1 on the embedding, then kernel 5), "
          f"same call: {_times(old)} bound_ms={pair_bound:.6f} (bytes, the two "
          f"kernels' bounds); decode form / pair device_ms "
          f"{t['device_ms'] / old['device_ms']:.3f}")
    records["bfp_decode_matmul"] = {
        "name": "bfp_decode_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/bfp_decode_matmul.cu",
        "body": "src/repro_torch/csrc/group_matmul_decode.cuh",
        "replaces": "src/repro/kernels/bfp_matmul.py:101",
        "loader_replaces": "src/repro/kernels/hif4_quant.py:75",
        "max_abs_err": worst, **t, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "library": "torch.matmul bf16 dense (M,K)x(K,N), not the same function",
        "shape": f"M={m} K={k} N={n}, bf16 weight (the pallas LM head)",
        "issue_floor_ms": floor_ms, "sass_per_lane": per_lane,
        "pair": dict(old, bound_ms=pair_bound)}
    del ops, args


def _packed_cache(b, s, hkv, d, gen, dev):
    import torch
    from repro_torch.core import kvcache

    k = (torch.randn(b, s, hkv, d, generator=gen) * 0.5).to(torch.bfloat16)
    v = (torch.randn(b, s, hkv, d, generator=gen) * 0.5).to(torch.bfloat16)
    pk = kvcache.to_kernel_layout(kvcache.quantize_kv(k.to(dev)))
    pv = kvcache.to_kernel_layout(kvcache.quantize_kv(v.to(dev)))
    return pk, pv


def attention_bound_ms(hkv, d, length, pages, tokens, heads=None) -> float:
    """Least time of one decode-attention call (bytes over the HBM rate; the
    q.k and p.V operations are far below the bf16 peak): per slot, K (codes
    and meta) and V codes of its valid tokens, the V meta of every token of
    its tiles (a NaN scale there reaches the output), q, the output,
    the lengths and the page table. ``pages`` None: a contiguous cache of
    ``tokens`` capacity; else a page table over pages of ``tokens`` tokens,
    each page read once however many slots hold it. ``heads`` query heads
    (default ``hkv``) read q and write the output, and each takes q.k and
    p.V over every valid token."""
    f, fq = hkv * d, (heads or hkv) * d
    kv_tok, vmeta_tok = f + 4 * (f // 64), 4 * (f // 64)    # K + V codes, K meta
    lens = [max(int(n), 0) for n in length.tolist()]
    b = len(lens)
    if pages is None:
        nbytes = sum(min(n, tokens) * kv_tok + tokens * vmeta_tok for n in lens)
        valid = sum(min(n, tokens) for n in lens)
    else:
        need: dict = {}
        for row, n in zip(pages.tolist(), lens):
            for k, pid in enumerate(row):
                need[pid] = max(need.get(pid, 0), min(max(n - k * tokens, 0), tokens))
        nbytes = sum(v * kv_tok + tokens * vmeta_tok for v in need.values())
        nbytes += pages.numel() * 4
        valid = sum(lens)
    nbytes += 2 * b * fq * 2 + b * 4                # q, out, lengths
    ops = 4 * valid * fq
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S) * 1e3


def masked_sdpa_ms(dense, length) -> float:
    """The yardstick at ragged lengths: one scaled_dot_product_attention
    call on the dequantized bf16 K/V ``dense`` [(q (B, H, 1, D), k, v (B, H,
    S, D)), ...] with each slot's keys past its length masked out."""
    import torch
    import torch.nn.functional as F

    s = dense[0][1].shape[2]
    mask = (torch.arange(s, device=length.device)[None, :]
            < length[:, None])[:, None, None, :]
    return cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), dense, iters=100)


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
    caches = [_packed_cache(B, cap, hkv, d, gen, dev) for _ in range(L2_ROTATION)]
    q = (torch.randn(B, hkv, d, generator=gen) * 0.5).to(torch.bfloat16).to(dev)
    length = torch.full((B,), cap, dtype=torch.int32, device=dev)
    args = [(q, pk, pv, length) for pk, pv in caches]
    t = timed(lambda *a: fused_decode_attention(*a, n_kv_heads=hkv, d_head=d),
              args, iters=100)
    plain_ms = cuda_ms(lambda *a: fused_decode_attention_plain(*a, hkv, d), args,
                       iters=20)
    dense = [(q[:, :, None], kvcache.dequantize_kv(pk, hkv, d).transpose(1, 2),
              kvcache.dequantize_kv(pv, hkv, d).transpose(1, 2)) for pk, pv in caches]
    library_ms = cuda_ms(F.scaled_dot_product_attention, dense, iters=100)
    bound_ms = attention_bound_ms(hkv, d, length, None, cap)
    print(f"  fused_decode_attention decode B=8 Hkv=16 D=64 S=512: {_times(t)} "
          f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} (bytes) "
          f"library_ms={library_ms:.5f} (scaled_dot_product_attention on the "
          f"dequantized bf16 K/V, not the same function)")
    # a solo serve's tiling: block_kv = P = 64, capacity 512 past the ragged
    # lengths of the paged phase's table (tiles past a length are walked)
    ragged = torch.tensor(RAGGED_LENGTH, dtype=torch.int32, device=dev)
    solo = [(q, pk, pv, ragged) for pk, pv in caches]
    out = fused_decode_attention(*solo[0], n_kv_heads=hkv, d_head=d, block_kv=64)
    ref = fused_decode_attention_plain(*solo[0], hkv, d, block_kv=64)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    worst = max(worst, float(err.max()))
    check(bool((err <= 1e-3 + 2 ** -7 * ref.float().abs()).all()),
          f"fused_decode_attention solo shape: max |d| {float(err.max())} "
          f"beyond rtol=2^-7, atol=1e-3")
    s_t = timed(lambda *a: fused_decode_attention(*a, n_kv_heads=hkv, d_head=d,
                                                  block_kv=64), solo, iters=100)
    s_plain_ms = cuda_ms(lambda *a: fused_decode_attention_plain(
        *a, hkv, d, block_kv=64), solo, iters=10)
    s_bound_ms = attention_bound_ms(hkv, d, ragged, None, cap)
    s_library_ms = masked_sdpa_ms(dense, ragged)
    # the models-level packed decode (one dequantized KV chunk at a time, in
    # plain PyTorch) against kernel 3 on the same cache and ragged lengths
    from repro_torch.models.attention import decode_attention_packed

    dap = decode_attention_packed(*solo[0], hkv, d)
    k3 = fused_decode_attention(*solo[0], n_kv_heads=hkv, d_head=d)
    torch.cuda.synchronize()
    dap_err = (dap.float() - k3.float()).abs()
    check(bool((dap_err <= 1e-3 + 2 ** -7 * k3.float().abs()).all()),
          f"decode_attention_packed vs kernel 3: max |d| "
          f"{float(dap_err.max())} beyond rtol=2^-7, atol=1e-3")
    dap_ms = cuda_ms(lambda *a: decode_attention_packed(*a, hkv, d), solo,
                     iters=10)
    print(f"  decode_attention_packed B=8 Hkv=16 D=64 S=512, lengths "
          f"{RAGGED_LENGTH}: max |d| {float(dap_err.max()):.3e} vs kernel 3 "
          f"(rtol 2^-7, atol 1e-3); {dap_ms:.5f} ms")
    print(f"  fused_decode_attention solo shape B=8 Hkv=16 D=64 S=512 "
          f"block_kv=64, lengths {RAGGED_LENGTH}: max |d| {float(err.max()):.3e} "
          f"vs plain; {_times(s_t)} plain_ms={s_plain_ms:.5f} "
          f"bound_ms={s_bound_ms:.6f} (bytes) library_ms={s_library_ms:.5f} "
          f"(scaled_dot_product_attention under the length mask, on the "
          f"dequantized K/V)")
    records["fused_decode_attention"] = {
        "name": "fused_decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_attention.cu",
        "replaces": "src/repro/kernels/fused_attention.py:176",
        "max_abs_err": worst, **t, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
        "library": "scaled_dot_product_attention on dequantized bf16 K/V, "
                   "not the same function",
        "shape": "B=8 Hkv=16 D=64 S=512",
        "solo": {"shape": f"B=8 Hkv=16 D=64 S=512 block_kv=64 lengths "
                          f"{RAGGED_LENGTH}", **s_t, "plain_ms": s_plain_ms,
                 "bound_ms": s_bound_ms, "bound_by": "bytes",
                 "library_ms": s_library_ms}}


def _kv_append_bound_ms(b, f, pages_numel=0, tensors=2):
    """The append's least time: each tensor's new rows (bf16) read, its codes,
    meta words and bf16 tail of the token written, the positions and the
    page table read, each byte once; 16 f32 ops per value (as kernel 1's
    bound) are far below the bytes' time."""
    g, t = divmod(f, 64)
    nbytes = tensors * b * (2 * f + 32 * g + 4 * g + 2 * t) + 8 * b \
        + 4 * pages_numel
    return max(nbytes / HBM_BYTES_PER_S,
               16 * tensors * b * f / F32_FLOPS_PER_S) * 1e3


def _kv_tokens(gen, b, hkv, d, dev, n):
    """``n`` (K, V) pairs of new tokens (B, 1, Hkv, Dh) bf16; the first pair
    holds a zero group, a NaN, +-Inf and bf16's top."""
    import torch

    out = []
    for i in range(n):
        k, v = ((torch.randn(b, 1, hkv, d, generator=gen) * 2).to(torch.bfloat16)
                for _ in range(2))
        if i == 0:
            k[0, 0, 0] = 0.0
            k[1, 0, 1, 3] = float("nan")
            k[2, 0, 2, 7] = float("inf")
            v[3, 0, 3, 9] = -float("inf")
            v[4, 0, 4] = torch.finfo(torch.bfloat16).max
        out.append((k.to(dev), v.to(dev)))
    return out


def check_kv_append(dev, records):
    """The per-token KV append (K and V of a layer in one launch) bitwise its
    plain version at qwen1.5-0.5b's decode shape (B 8, Hkv 16, Dh 64): the
    contiguous kernel-tile cache (capacity 488, per-slot positions, one past
    the capacity) and the paged pool (P 64, a ragged table: slots 5-7 own no
    page and collide in the scratch page 0, which the comparison leaves
    out; slot 4's position is past its row), every leaf's bytes; timed on
    the contiguous cache."""
    import torch
    from repro_torch.core import kvcache
    from repro_torch.kernels.kv_append import kv_append

    gen = torch.Generator().manual_seed(26)
    b, hkv, d, cap, P = 8, 16, 64, 488, 64
    f = hkv * d
    g, _ = divmod(f, 64)

    def cache(rows, tokens):
        return {"codes": torch.randint(0, 256, (rows, g * 32, tokens),
                                       dtype=torch.uint8, generator=gen).to(dev),
                "meta": torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, g, tokens),
                                      dtype=torch.int32, generator=gen).to(dev),
                "tail": torch.zeros(rows, 0, tokens, dtype=torch.bfloat16,
                                    device=dev)}

    def clone(c):
        return {key: {k: a.clone() for k, a in c[key].items()} for key in c}

    news = _kv_tokens(gen, b, hkv, d, dev, 4)
    pos = torch.tensor([480, 481, 0, 63, 64, 300, 487, 500], device=dev)
    table = torch.zeros(b, 8, dtype=torch.int32)
    table[:5] = torch.arange(1, 41, dtype=torch.int32).reshape(5, 8)
    table[4, 5:] = 0                       # slot 4: pos 64 + 5 * 64 past it
    table = table.to(dev)
    ppos = torch.tensor([480, 70, 3, 511, 400, 5, 6, 7], device=dev)
    worst = 0
    for label, rows, tokens, pages, ps in (
            ("contiguous", b, cap, None, pos), ("paged", 41, P, table, ppos)):
        base = {"k": cache(rows, tokens), "v": cache(rows, tokens)}
        got, want = clone(base), clone(base)
        for i, (k, v) in enumerate(news):
            kvcache.append_kv(got, k, v, ps + i, pages)
            kvcache.kv_append_plain([want["k"], want["v"]], [k, v], ps + i, pages)
        torch.cuda.synchronize()
        for t in ("k", "v"):
            for key in ("codes", "meta"):
                x, y = got[t][key], want[t][key]
                if pages is not None:
                    x, y = x[1:], y[1:]
                n = int((x != y).sum())
                worst = max(worst, n)
                check(n == 0, f"kv_append {label}: {n} {t}.{key} bytes differ "
                      f"from the plain version")
        print(f"  kv_append {label} B={b} Hkv={hkv} D={d} "
              f"{'P=64 ragged table' if pages is not None else f'S={cap}'}: "
              f"4 appends bitwise the plain version (NaN, +-Inf, zeros, "
              f"bf16's top among the tokens"
              f"{'; page 0 left out' if pages is not None else ''})")
    caches = [{"k": cache(b, cap), "v": cache(b, cap)} for _ in range(4)]
    args = [([c["k"], c["v"]], [k, v], pos) for c, (k, v) in zip(caches, news)]
    t = timed(kv_append, args)
    plain_ms = cuda_ms(kvcache.kv_append_plain, args, iters=20)
    bound_ms = _kv_append_bound_ms(b, f)
    print(f"  kv_append contiguous B={b} Hkv={hkv} D={d} S={cap}: {_times(t)} "
          f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} (bytes); no "
          f"PyTorch call computes it (library_ms null)")
    records["kv_append"] = {
        "name": "kv_append", "route": "cuda",
        "source": "src/repro_torch/csrc/kv_append.cu",
        "replaces": "no TPU kernel: src/repro/core/kvcache.py:278 and :418 "
                    "(append_token, append_token_paged) under jit",
        "max_abs_err": float(worst), **t, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "shape": f"K and V (B={b}, 1, Hkv={hkv}, D={d}) into S={cap}"}


def _paged_pool(n_pages, P, hkv, d, gen, dev):
    """Per-layer pool leaves (NP, F/2, P) / (NP, G, P) holding real
    quantized tokens."""
    import torch
    from repro_torch.core import kvcache

    kv = (torch.randn(n_pages * P, hkv, d, generator=gen) * 0.5).to(torch.bfloat16)
    pk = kvcache.to_kernel_layout(kvcache.quantize_kv(kv.to(dev)))
    return {key: a.reshape(a.shape[0], n_pages, P).transpose(0, 1).contiguous()
            for key, a in pk.items()}


def _contiguous_from_pages(pool, pages):
    """The bytes a page table names, laid out as a contiguous cache
    (B, F, max_pages * P)."""
    out = {}
    for key, a in pool.items():
        g = a[pages.long()]                                 # (B, maxp, F, P)
        b, maxp, f, p = g.shape
        out[key] = g.permute(0, 2, 1, 3).reshape(b, f, maxp * p).contiguous()
    return out


def _compare_paged(q, kp, vp, pages, length, hkv, d, P, label) -> float:
    """Kernel 4 against its plain version (rtol 2^-7, atol 1e-3) and against
    kernel 3 at block_kv = P on the same bytes laid out contiguously
    (bitwise); returns the max |d| against the plain version."""
    import torch
    from repro_torch.kernels.fused_attention import (
        fused_decode_attention, fused_paged_decode_attention,
        fused_paged_decode_attention_plain)

    out = fused_paged_decode_attention(q, kp, vp, pages, length,
                                       n_kv_heads=hkv, d_head=d)
    ref = fused_paged_decode_attention_plain(q, kp, vp, pages, length, hkv, d)
    cont = fused_decode_attention(q, _contiguous_from_pages(kp, pages),
                                  _contiguous_from_pages(vp, pages), length,
                                  n_kv_heads=hkv, d_head=d, block_kv=P)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    check(bool((err <= 1e-3 + 2 ** -7 * ref.float().abs()).all()),
          f"fused_paged_decode_attention {label}: max |d| {float(err.max())} "
          f"beyond rtol=2^-7, atol=1e-3")
    check(torch.equal(out.view(torch.int16), cont.view(torch.int16)),
          f"fused_paged_decode_attention {label}: not bitwise equal to "
          f"fused_decode_attention at block_kv={P}")
    print(f"  fused_paged_decode_attention {label}: max |d| {float(err.max()):.3e} "
          f"vs plain; bitwise equal to fused_decode_attention at block_kv={P}")
    return float(err.max())


# the paged phase's ragged table (pages of 64, 8 entries a slot, a 24-page
# pool): a shared prefix, partial last pages, trailing scratch entries, a
# 33-token slot
RAGGED_TABLE = [[1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 9, 10, 11, 0],
                [1, 2, 3, 4, 9, 12, 0, 0], [1, 2, 3, 4, 13, 14, 15, 16],
                [17, 18, 19, 20, 21, 0, 0, 0], [1, 2, 3, 4, 22, 0, 0, 0],
                [23, 0, 0, 0, 0, 0, 0, 0], [1, 2, 3, 4, 5, 6, 7, 8]]
RAGGED_LENGTH = [512, 443, 360, 511, 320, 257, 33, 449]


def _table_case(max_pages, P, hkv, d, gen, dev):
    """Four slots over a pool of 1 + 4 * max_pages pages: a full table, one
    ending in a partial page and a trailing scratch entry, a 1-token slot
    (every other entry scratch) and a slot of length 0."""
    import torch

    kp, vp = (_paged_pool(1 + 4 * max_pages, P, hkv, d, gen, dev) for _ in range(2))
    ids = torch.arange(1, 1 + 4 * max_pages, dtype=torch.int32).reshape(4, max_pages)
    if max_pages > 1:
        ids[1, -1] = 0
    ids[2, 1:] = 0
    length = torch.tensor([max_pages * P, max(1, (max_pages - 1) * P - 3), 1, 0],
                          dtype=torch.int32)
    q = (torch.randn(4, hkv, d, generator=gen) * 0.5).to(torch.bfloat16)
    return q.to(dev), kp, vp, ids.to(dev), length.to(dev)


def check_paged_attention(dev, records):
    """Kernel 4 against its plain version (rtol 2^-7, atol 1e-3) and against
    kernel 3 at block_kv = P on the same bytes laid out contiguously
    (bitwise), on tables with pages shared by two slots, trailing scratch
    entries and partial last pages; NaN metadata in one page reaches only
    the slots holding it; then timed at the decode shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kvcache
    from repro_torch.kernels.fused_attention import (
        fused_paged_decode_attention, fused_paged_decode_attention_plain)

    gen = torch.Generator().manual_seed(14)
    worst = 0.0
    pages = torch.tensor([[3, 7, 1, 9], [3, 7, 4, 10], [2, 11, 0, 0], [5, 0, 0, 0],
                          [6, 8, 12, 13], [14, 15, 0, 0], [3, 16, 17, 0],
                          [18, 19, 20, 21]], dtype=torch.int32, device=dev)
    for hkv, d in ((16, 64), (4, 32)):
        for P in (16, 64):
            kp = _paged_pool(24, P, hkv, d, gen, dev)
            vp = _paged_pool(24, P, hkv, d, gen, dev)
            q = (torch.randn(8, hkv, d, generator=gen) * 0.5).to(torch.bfloat16).to(dev)
            length = torch.tensor([4 * P, 3 * P + 1, P + P // 2, 1, 4 * P - 1,
                                   2 * P, 2 * P + 3, 3 * P + P // 4],
                                  dtype=torch.int32, device=dev)
            label = f"Hkv={hkv} D={d} P={P} max_pages=4"
            worst = max(worst, _compare_paged(q, kp, vp, pages, length, hkv, d,
                                              P, label))
            # trailing scratch entries are exact no-ops: slots 2 and 3 with
            # their tables cut to two entries give the same bits
            out = fused_paged_decode_attention(q, kp, vp, pages, length,
                                               n_kv_heads=hkv, d_head=d)
            cut = fused_paged_decode_attention(
                q[2:4], kp, vp, pages[2:4, :2].contiguous(), length[2:4],
                n_kv_heads=hkv, d_head=d)
            torch.cuda.synchronize()
            check(torch.equal(out[2:4].view(torch.int16), cut.view(torch.int16)),
                  f"fused_paged_decode_attention {label}: trailing scratch "
                  f"entries changed the output")
            print(f"  fused_paged_decode_attention {label}: trailing scratch "
                  f"entries exact no-ops")
            bad = {key: t.clone() for key, t in kp.items()}
            bad["meta"][7, 0, 2] |= -(1 << 24)     # page 7: slots 0 and 1 only
            out = fused_paged_decode_attention(q, bad, vp, pages, length,
                                               n_kv_heads=hkv, d_head=d)
            ref = fused_paged_decode_attention_plain(q, bad, vp, pages, length, hkv, d)
            torch.cuda.synchronize()
            holders = out.isnan().flatten(1).any(1).tolist()
            check(torch.equal(out.isnan(), ref.isnan())
                  and holders == [True, True] + [False] * 6,
                  f"fused_paged_decode_attention Hkv={hkv} D={d} P={P}: NaN "
                  f"reached slots {holders}, expected the holders of page 7")
    print("  fused_paged_decode_attention: E6M2 0xFF meta in a page -> NaN in "
          "the two slots whose tables hold it, as in the plain version")
    # every tile count the launch plan meets: kernel 4 bitwise kernel 3 at
    # block_kv = P, trailing scratch entries and a slot of length 0 included
    hkv, d, P = 16, 64, 64
    for max_pages in (1, 2, 3, 8, 33):
        q, kp, vp, pages, length = _table_case(max_pages, P, hkv, d, gen, dev)
        worst = max(worst, _compare_paged(q, kp, vp, pages, length, hkv, d, P,
                                          f"{max_pages} tiles, lengths "
                                          f"{length.tolist()}"))
        out = fused_paged_decode_attention(q, kp, vp, pages, length,
                                           n_kv_heads=hkv, d_head=d)
        ref = fused_paged_decode_attention_plain(q, kp, vp, pages, length, hkv, d)
        torch.cuda.synchronize()
        check(torch.equal(out[3].view(torch.int16), ref[3].view(torch.int16)),
              f"fused_paged_decode_attention {max_pages} tiles: the length-0 slot "
              f"is not bitwise the plain version's")
    print("  fused_paged_decode_attention: a slot of length 0 bitwise equal to "
          "the plain version at 1, 2, 3, 8, 33 tiles")
    # a NaN V scale in the scratch page: p = 0 there, but 0 * NaN reaches
    # the slots whose tables hold the page past their length; a NaN K scale
    # there is masked
    q, kp, vp, pages, length = _table_case(3, P, hkv, d, gen, dev)
    vp["meta"][0, 0, 5] |= -(1 << 24)
    kp["meta"][0, 1, 7] |= -(1 << 24)
    out = fused_paged_decode_attention(q, kp, vp, pages, length,
                                       n_kv_heads=hkv, d_head=d)
    ref = fused_paged_decode_attention_plain(q, kp, vp, pages, length, hkv, d)
    torch.cuda.synchronize()
    holders = out.isnan().flatten(1).any(1).tolist()
    check(torch.equal(out.isnan(), ref.isnan())
          and holders == [False, True, True, False],
          f"fused_paged_decode_attention: a NaN V scale in the scratch page "
          f"reached slots {holders}, expected [False, True, True, False] "
          f"(the slots with trailing entries), as the plain version")
    print("  fused_paged_decode_attention: E6M2 0xFF V meta in the scratch page "
          "-> NaN in exactly the slots with trailing entries, as in the plain "
          "version; a NaN K scale there is masked")
    # the paged phase's shape: 24 pages of P=64, tables of 8 entries (tiles
    # 4-7 in use), lengths up to 8P, a shared prefix, partial last pages
    # and trailing scratch entries
    B, hkv, d, P, maxp = 8, 16, 64, 64, 8
    main = torch.tensor(RAGGED_TABLE, dtype=torch.int32, device=dev)
    ragged_pools = [(_paged_pool(24, P, hkv, d, gen, dev),
                     _paged_pool(24, P, hkv, d, gen, dev)) for _ in range(L2_ROTATION)]
    q = (torch.randn(B, hkv, d, generator=gen) * 0.5).to(torch.bfloat16).to(dev)
    length = torch.tensor(RAGGED_LENGTH, dtype=torch.int32, device=dev)
    worst = max(worst, _compare_paged(q, *ragged_pools[0], main, length, hkv,
                                      d, P, "Hkv=16 D=64 P=64 max_pages=8 NP=24"))
    r_args = [(q, kp, vp, main, length) for kp, vp in ragged_pools]
    r_t = timed(lambda *a: fused_paged_decode_attention(*a, n_kv_heads=hkv, d_head=d),
                r_args, iters=100)
    r_plain_ms = cuda_ms(lambda *a: fused_paged_decode_attention_plain(*a, hkv, d),
                         r_args, iters=10)
    r_bound_ms = attention_bound_ms(hkv, d, length, main, P)
    r_dense = [(q[:, :, None],
                kvcache.dequantize_kv(_contiguous_from_pages(kp, main), hkv,
                                      d).transpose(1, 2),
                kvcache.dequantize_kv(_contiguous_from_pages(vp, main), hkv,
                                      d).transpose(1, 2))
               for kp, vp in ragged_pools]
    r_library_ms = masked_sdpa_ms(r_dense, length)
    del r_dense
    print(f"  fused_paged_decode_attention ragged table B=8 Hkv=16 D=64 P=64 "
          f"max_pages=8 NP=24: {_times(r_t)} plain_ms={r_plain_ms:.5f} "
          f"bound_ms={r_bound_ms:.6f} (bytes) library_ms={r_library_ms:.5f} "
          f"(scaled_dot_product_attention under the length mask, on the "
          f"gathered, dequantized K/V)")
    del ragged_pools, r_args
    n_pages = 1 + B * maxp
    table = torch.arange(1, n_pages, dtype=torch.int32, device=dev).reshape(B, maxp)
    pools = [(_paged_pool(n_pages, P, hkv, d, gen, dev),
              _paged_pool(n_pages, P, hkv, d, gen, dev)) for _ in range(L2_ROTATION)]
    q = (torch.randn(B, hkv, d, generator=gen) * 0.5).to(torch.bfloat16).to(dev)
    length = torch.full((B,), maxp * P, dtype=torch.int32, device=dev)
    args = [(q, kp, vp, table, length) for kp, vp in pools]
    worst = max(worst, _compare_paged(*args[0], hkv, d, P,
                                      "timed shape B=8 Hkv=16 D=64 P=64 max_pages=8"))
    t = timed(lambda *a: fused_paged_decode_attention(*a, n_kv_heads=hkv, d_head=d),
              args, iters=100)
    plain_ms = cuda_ms(lambda *a: fused_paged_decode_attention_plain(*a, hkv, d),
                       args, iters=20)
    dense = []
    for kp, vp in pools:
        kd = kvcache.dequantize_kv(_contiguous_from_pages(kp, table), hkv, d)
        vd = kvcache.dequantize_kv(_contiguous_from_pages(vp, table), hkv, d)
        dense.append((q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)))
    library_ms = cuda_ms(F.scaled_dot_product_attention, dense, iters=100)
    bound_ms = attention_bound_ms(hkv, d, length, table, P)
    print(f"  fused_paged_decode_attention decode B=8 Hkv=16 D=64 P=64 "
          f"max_pages=8: {_times(t)} plain_ms={plain_ms:.5f} "
          f"bound_ms={bound_ms:.6f} (bytes) library_ms="
          f"{library_ms:.5f} (scaled_dot_product_attention on the gathered, "
          f"dequantized bf16 K/V, not the same function)")
    records["fused_paged_decode_attention"] = {
        "name": "fused_paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_attention.cu",
        "replaces": "src/repro/kernels/fused_attention.py:312",
        "max_abs_err": worst, **t, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
        "library": "scaled_dot_product_attention on gathered, dequantized "
                   "bf16 K/V, not the same function",
        "shape": "B=8 Hkv=16 D=64 P=64 max_pages=8",
        "ragged": {"shape": f"B=8 Hkv=16 D=64 P=64 table {RAGGED_TABLE} lengths "
                            f"{RAGGED_LENGTH}", **r_t, "plain_ms": r_plain_ms,
                   "bound_ms": r_bound_ms, "bound_by": "bytes",
                   "library_ms": r_library_ms}}


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------


def serving_setup(cfg, policy: str = "paper-iv", impl: str = "packed"):
    """A serving context with HiF4 KV: a preset under ``impl``, or ``head``,
    the paper-iv rules without the lm_head exclusion under impl pallas,
    built as the rule list a ``--policy`` JSON carries."""
    from repro_torch.core import kvcache
    from repro_torch.core.policy import QuantPolicy, QuantRule, get_policy
    from repro_torch.models import lm
    from repro_torch.models.common import ModelCtx

    if policy == "head":
        pol = QuantPolicy(rules=(QuantRule("*", fmt="hif4", impl="pallas"),
                                 QuantRule("embed", fmt="none"),
                                 QuantRule("*.router", fmt="none")),
                          kv=kvcache.KV_HIF4, name="hif4-with-head")
    else:
        pol = get_policy(policy, impl=impl, kv=kvcache.KV_HIF4)
    return ModelCtx(plan=lm.quant_plan(cfg, pol))


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
    # prefill (M = 3840 rows): kernel 1, then kernel 2's prefill form; each
    # decode step (M = 8): one launch of the decode form per linear
    want = {"hif4_quantize": cfg.n_layers * sites,
            "fused_packed_matmul": cfg.n_layers * sites * (1 + steps),
            "fused_decode_matmul": cfg.n_layers * sites * steps,
            "fused_decode_attention": cfg.n_layers * steps,
            "fused_paged_decode_attention": 0, "bfp_matmul_quantized": 0,
            "bfp_decode_matmul": 0, "kv_append": cfg.n_layers * steps}
    print(f"  launches on the main path: {launches} (expected {want})")
    check(launches == want, f"launch counts {launches} != expected {want}")
    for name, n in launches.items():
        if n:
            records.setdefault(name, {})["launches"] = n
    # each shape's launches as the wrappers counted them in this run; every
    # matmul launch of the run at one of the timed shapes, the row's sites
    # ratio held, and the forms' totals the per-shape sums
    per_shape = dict(build.SHAPE_LAUNCHES)
    for name, m, rec in (("fused_decode_matmul", batch, "fused_decode_matmul"),
                         ("fused_packed_matmul", batch * prompt,
                          "fused_packed_matmul")):
        counted = {key[1]: n for key, n in per_shape.items() if key[0] == name}
        for sh in records[rec].get("shapes", []):
            k, n = sh["k_n"]
            sh["launches"] = counted.get((m, k, n), 0) if sh["shape"].startswith(
                f"M={m} ") else 0
        timed_n = sum(sh["launches"] for sh in records[rec].get("shapes", []))
        print(f"  {name} launches per (M, K, N): {counted}")
        check(sum(counted.values()) == timed_n == (
            launches[name] if name == "fused_decode_matmul" else
            launches[name] - launches["fused_decode_matmul"]),
            f"{name}: launches per shape {counted} do not sum to the run's "
            f"count, or fall outside the timed shapes")
        check(counted == {(m, k, n): cfg.n_layers * (steps if name ==
                          "fused_decode_matmul" else 1) * DECODE_SITES[(k, n)]
                          for k, n in DECODE_SHAPES},
              f"{name}: launches per shape {counted} are not the layers' "
              f"4 : 2 : 1")
    # the kernel 2 row is its prefill form; both forms count under its name
    records["fused_packed_matmul"]["launches"] = (
        launches["fused_packed_matmul"] - launches["fused_decode_matmul"])
    records["fused_packed_matmul"]["launches_both_forms"] = launches[
        "fused_packed_matmul"]
    print(f"  request 0: {toks[0].tolist()}")


def phase_pallas(dev, seed, records):
    """The dense pallas route at full width and depth: the packed body
    (kernels 1-3) and the LM head quantizing the activations (kernel 1) and
    the tied embedding (in the loader of kernel 5's decode form) per call;
    then the same
    weights under nvfp4-baseline; the four formats' qdq on the card against
    the CPU; the quantized matmul of kernels.ops against the f32 product."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import metrics
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import build, ops
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        ServeConfig, prepare_params_for_serving, serve, serving_ctx)

    cfg = get_arch("qwen1.5-0.5b")
    batch, prompt, new = 8, 480, 32
    ctx = serving_setup(cfg, "head")
    head = ctx.plan.site("lm_head")
    check((head.cfg.fmt, head.cfg.impl, head.packed) == ("hif4", "pallas", False)
          and len(ctx.plan.packed_paths) == 7,
          f"head policy plan: lm_head {head}, packed {ctx.plan.packed_paths}")
    # the blocks and the embedding (so the tied head too) at 5x the init's
    # scale, as in the paged phase: greedy tokens then change from step to
    # step, so a wrong head shows in the tokens
    params = lm.init_params(cfg, seed, device="cpu")
    params = dict(params, blocks=_scaled(params["blocks"], 5.0),
                  embed=params["embed"] * 5.0)
    sparams = prepare_params_for_serving(params, cfg, ctx.plan, device=dev)
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen)
    serve(cfg, sparams, {"tokens": tokens[:, :64]}, ctx,
          ServeConfig(max_new_tokens=2), device=dev)          # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    stats: dict = {}
    with head_inputs() as seen:
        toks = serve(cfg, sparams, {"tokens": tokens}, ctx,
                     ServeConfig(max_new_tokens=new), device=dev, stats=stats)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    steps = stats["decode_steps"]
    print(f"  lm_head: {head.cfg.fmt} {head.cfg.impl} dense (tied -> embed); "
          f"prefill {stats['prefill_s'] * 1e3:.1f} ms for {batch} x {prompt}; "
          f"decode {stats['decode_s'] * 1e3 / steps:.2f} ms/token step "
          f"({batch * steps / stats['decode_s']:.1f} tokens/s over {steps} "
          f"steps); {card_line()}")
    check(tuple(toks.shape) == (batch, new), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token ids out of range")
    calls = 1 + steps                         # LM-head calls: prefill + decode
    sites = 7
    # every head call has batch rows (each request's last position): kernel
    # 1 on them, then the decode form of kernel 5, which quantizes the
    # embedding in its loader; kernel 5 counts both of its forms
    want = {"hif4_quantize": cfg.n_layers * sites + calls,
            "fused_packed_matmul": cfg.n_layers * sites * calls,
            "fused_decode_matmul": cfg.n_layers * sites * steps,
            "fused_decode_attention": cfg.n_layers * steps,
            "fused_paged_decode_attention": 0,
            "bfp_matmul_quantized": calls, "bfp_decode_matmul": calls,
            "kv_append": cfg.n_layers * steps}
    print(f"  launches in the pallas run: {launches} (expected {want})")
    check(launches == want, f"launch counts {launches} != expected {want}")
    per_shape = {key[1]: v for key, v in build.SHAPE_LAUNCHES.items()
                 if key[0] == "bfp_decode_matmul"}
    print(f"  bfp_decode_matmul launches per (M, K, N): {per_shape}")
    check(per_shape == {(batch, cfg.d_model, cfg.vocab): calls},
          f"bfp_decode_matmul launches per shape {per_shape}")
    records.setdefault("bfp_decode_matmul", {})["launches"] = launches[
        "bfp_decode_matmul"]
    # kernel 5's row: both forms, as its counter counts them; its int8 form
    # (pre-quantized operands) runs on no main path now
    records.setdefault("bfp_matmul_quantized", {}).update(
        launches=launches["bfp_matmul_quantized"],
        launches_int8_form=(launches["bfp_matmul_quantized"]
                            - launches["bfp_decode_matmul"]),
        launches_decode_form=launches["bfp_decode_matmul"])
    if "hif4_quantize" in records:   # 0 on the embedding: the decode form
        records["hif4_quantize"]["embedding"]["launches_pallas"] = 0
    print(f"  request 0: {toks[0].tolist()}")
    _check_tokens_vary("pallas", toks)

    # the head at the last decode step, on the hidden state it was given:
    # kernel 1 and the decode form against their plain versions on the card,
    # bitwise, and
    # the served token is the logits' argmax
    sctx = serving_ctx(ctx)
    x = seen[-1]
    on_card = lm.lm_logits(sparams, x, cfg, sctx)[:, 0]
    with plain_versions():
        plain = lm.lm_logits(sparams, x, cfg, sctx)[:, 0]
    same = torch.equal(on_card.view(torch.int32), plain.view(torch.int32))
    picked = torch.equal(torch.argmax(on_card, dim=-1).cpu(), toks[:, -1].cpu())
    print(f"  lm_head at decode step {len(seen) - 1}: kernels vs plain versions "
          f"on the card bitwise {same}; finite {bool(on_card.isfinite().all())}; "
          f"argmax == served token {picked}")
    check(same and picked and bool(on_card.isfinite().all()),
          "the LM head at the last decode step: kernels != plain versions, "
          "non-finite logits, or the served token is not their argmax")

    # the same weights under nvfp4-baseline: fake-quant NVFP4+PTS body, bf16
    # head, HiF4 KV through kernel 3
    base_ctx = serving_setup(cfg, "nvfp4-baseline", impl="pallas")
    build.reset_launches()
    stats = {}
    toks = serve(cfg, params, {"tokens": tokens}, base_ctx,
                 ServeConfig(max_new_tokens=8), device=dev, stats=stats)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    steps = stats["decode_steps"]
    print(f"  nvfp4-baseline: decode {stats['decode_s'] * 1e3 / steps:.2f} "
          f"ms/token step; launches {launches}; request 0: {toks[0].tolist()}")
    _check_tokens_vary("nvfp4-baseline", toks)
    check(launches["fused_packed_matmul"] == 0
          and launches["bfp_matmul_quantized"] == 0
          and launches["fused_decode_attention"] == cfg.n_layers * steps
          and launches["kv_append"] == cfg.n_layers * steps,
          f"nvfp4-baseline launches {launches}: kernels 2 and 5 must not run, "
          f"kernel 3 and the KV append {cfg.n_layers} x {steps} times")
    del params, sparams

    # formats on the card: qdq bitwise equal to the CPU port's
    g = torch.Generator().manual_seed(seed + 6)
    w = torch.randn(1024, 1024, generator=g) * 0.01
    mse = {}
    for fmt in metrics.QDQ_FORMATS:
        q = get_format(fmt).qdq
        on_card, on_cpu = q(w.to(dev)).cpu(), q(w)
        check(torch.equal(on_card.view(torch.int32), on_cpu.view(torch.int32)),
              f"{fmt} qdq on the card differs from the CPU at "
              f"{int((on_card != on_cpu).sum())} values")
        mse[fmt] = metrics.qdq_error(w.to(dev), fmt)
    print(f"  qdq of a 1024 x 1024 N(0, 0.01^2) matrix: hif4, nvfp4, nvfp4_pts, "
          f"mxfp4 bitwise equal card vs CPU; MSE ratio to hif4 "
          + ", ".join(f"{f} {mse[f] / mse['hif4']:.3f}" for f in mse)
          + " (the paper's plateau 1 : 1.32 : 1.89 for hif4 : nvfp4 : mxfp4)")

    # the user-facing quantized matmul (the reference's accuracy claims)
    x = torch.randn(32, 512, generator=g).to(dev) * 0.5
    wm = torch.randn(512, 32, generator=g).to(dev) * 0.05
    exact = x @ wm
    rel = float(torch.linalg.norm(ops.matmul(x, wm) - exact) / torch.linalg.norm(exact))
    mx = get_format("mxfp4")
    rel_mx = float(torch.linalg.norm(mx.qdq(x, axis=-1) @ mx.qdq(wm, axis=0) - exact)
                   / torch.linalg.norm(exact))
    print(f"  ops.matmul (32, 512) x (512, 32): relative error {rel:.4f} to the "
          f"f32 product (MXFP4 qdq {rel_mx:.4f})")
    check(rel < 0.2 and rel < rel_mx, f"ops.matmul relative error {rel} "
          f"(must be < 0.2 and < MXFP4's {rel_mx})")


def _check_tokens_vary(label, toks):
    distinct = [len(set(r.tolist())) for r in toks]
    print(f"  {label}: distinct tokens per request {distinct}")
    check(min(distinct) > 1, f"{label}: a request repeats one token")


@contextlib.contextmanager
def head_inputs():
    """Record the final hidden state each call of the LM head is given."""
    from repro_torch.models import lm

    seen, head = [], lm.lm_logits

    def capture(p, x, c, mctx):
        seen.append(x)
        return head(p, x, c, mctx)

    lm.lm_logits = capture
    try:
        yield seen
    finally:
        lm.lm_logits = head


@contextlib.contextmanager
def plain_versions():
    """Route the engine's kernel entry points and the KV append to their
    plain PyTorch versions (for a run on the card that launches no kernel of
    the port)."""
    from repro_torch.core import engine, kvcache
    from repro_torch.kernels import ops
    from repro_torch.kernels.bfp_matmul import (
        bfp_decode_matmul_plain, bfp_matmul_quantized_plain)
    from repro_torch.kernels.fused_attention import fused_decode_attention_plain
    from repro_torch.kernels.fused_matmul import (
        fused_decode_matmul_plain, fused_packed_matmul_plain)
    from repro_torch.kernels.hif4_quant import absorbed_activation

    saved = (engine.hif4_quantize, engine.fused_packed_matmul,
             engine.fused_decode_matmul, engine.fused_decode_attention,
             ops.hif4_quantize, ops.bfp_matmul_quantized, ops.bfp_decode_matmul,
             kvcache.kv_append)
    engine.hif4_quantize = ops.hif4_quantize = absorbed_activation
    kvcache.kv_append = kvcache.kv_append_plain
    engine.fused_packed_matmul = fused_packed_matmul_plain
    engine.fused_decode_matmul = fused_decode_matmul_plain
    engine.fused_decode_attention = (
        lambda q, k, v, length, *, n_kv_heads, d_head, block_kv=None:
        fused_decode_attention_plain(q, k, v, length, n_kv_heads, d_head,
                                     block_kv=block_kv))
    ops.bfp_matmul_quantized = bfp_matmul_quantized_plain
    ops.bfp_decode_matmul = bfp_decode_matmul_plain
    try:
        yield
    finally:
        (engine.hif4_quantize, engine.fused_packed_matmul,
         engine.fused_decode_matmul, engine.fused_decode_attention,
         ops.hif4_quantize, ops.bfp_matmul_quantized,
         ops.bfp_decode_matmul, kvcache.kv_append) = saved


# card vs CPU: the largest share of prefill logits outside rtol=0.05,
# atol=0.1 per policy. Under the head policy the HiF4 head re-quantizes the
# body's last-bit card/CPU differences and amplifies them; its limit lies
# between its reading and the CPU's own share under a reordered attention
# (printed beside it), the model's sensitivity to float order
E2E_SHARE = {"paper-iv": 0.01, "head": 0.10}
# attention chunks of the reordered CPU run
REORDER_CHUNK = 16


def phase_e2e(dev, seed):
    """A 2-layer cut at full width from one set of weights, served three
    ways under each of paper-iv (impl packed) and the head policy (impl
    pallas, LM head through kernel 5's decode form): on the card through
    the kernels, on the card through the plain versions, and on the CPU
    (plain versions)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"), n_layers=2)
    params = lm.init_params(cfg, seed + 2, device="cpu")
    E2E_INIT_SHARES.update(e2e_compare(dev, cfg, params, e2e_prompts(cfg, seed)))


def e2e_prompts(cfg, seed):
    """Phase e2e's prompts: (2, 64) tokens uniform over the vocabulary."""
    import torch

    gen = torch.Generator().manual_seed(seed + 3)
    return torch.randint(0, cfg.vocab, (2, 64), generator=gen)


# the init-scale weights' card vs cpu shares, kept for the trained model's
E2E_INIT_SHARES: dict = {}


E2E_SERVE_TOKENS = 8


def _prefill_logits(cfg, params, tokens, ctx, d, sp=None):
    """(f32 prefill logits on the CPU, the serving params on ``d``) of
    ``params`` (on the CPU) prepared under ``ctx``'s plan, or of ``sp``."""
    from repro_torch.runtime.serve_loop import (
        ServeConfig, build_decode_cache, prepare_params_for_serving,
        serving_ctx)

    if sp is None:
        sp = prepare_params_for_serving(params, cfg, ctx.plan, device=d)
    lg, _ = build_decode_cache(cfg, sp, {"tokens": tokens.to(d)},
                               serving_ctx(ctx),
                               ServeConfig(max_new_tokens=E2E_SERVE_TOKENS))
    return lg.float().cpu(), sp


def e2e_prefill_shares(dev, cfg, params, tokens) -> dict:
    """Each policy's share of prefill logits outside rtol=0.05, atol=0.1
    card (kernels) vs cpu (plain versions), printed: the number
    :func:`e2e_compare` returns, without its serves."""
    import torch

    shares = {}
    for policy in ("paper-iv", "head"):
        ctx = serving_setup(cfg, policy)
        card = _prefill_logits(cfg, params, tokens, ctx, dev)[0]
        cpu = _prefill_logits(cfg, params, tokens, ctx, torch.device("cpu"))[0]
        shares[policy] = _outside_share(f"{ctx.plan.policy.name}, card vs cpu",
                                        card, cpu)
    return shares


def e2e_compare(dev, cfg, params, tokens) -> dict:
    """Serve ``params`` (on the CPU) three ways under paper-iv and the head
    policy; returns each policy's share of prefill logits outside
    rtol=0.05, atol=0.1 card vs cpu, bounded by E2E_SHARE. Card kernels vs
    card plain versions stay bitwise; tokens go through
    :func:`_check_tokens`."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.runtime.serve_loop import ServeConfig, serve

    sc = ServeConfig(max_new_tokens=E2E_SERVE_TOKENS)
    cpu = torch.device("cpu")
    shares = {}
    for policy in ("paper-iv", "head"):
        ctx = serving_setup(cfg, policy)
        runs = {}

        def run(name, d):
            t0 = time.perf_counter()
            lg, sp = _prefill_logits(cfg, params, tokens, ctx, d)
            toks = serve(cfg, sp, {"tokens": tokens}, ctx, sc, device=d)
            runs[name] = (lg, toks.cpu(), d)
            print(f"  {name}: prepared, prefilled and served in "
                  f"{time.perf_counter() - t0:.1f} s")
            return sp

        print(f"  policy {ctx.plan.policy.name}:")
        build.reset_launches()
        run("card", dev)
        ran = {k for k, n in build.LAUNCHES.items() if n}
        want = {"hif4_quantize", "fused_packed_matmul", "fused_decode_matmul",
                "fused_decode_attention", "kv_append"}
        if policy == "head":               # the head: kernel 5's decode form
            want |= {"bfp_matmul_quantized", "bfp_decode_matmul"}
        check(ran == want, f"the card run launched {build.LAUNCHES}")
        with plain_versions():
            run("card-plain", dev)
        sp_cpu = run("cpu", cpu)

        lg_k, toks_k, _ = runs["card"]
        lg_p, toks_p, _ = runs["card-plain"]
        print(f"  card kernels vs card plain versions: prefill logits bitwise "
              f"{torch.equal(lg_k, lg_p)}, greedy tokens equal "
              f"{torch.equal(toks_k, toks_p)}")
        check(torch.equal(lg_k, lg_p), "prefill logits: kernels != plain versions")
        _check_tokens("card kernels vs card plain", toks_k, "card-plain", runs,
                      cfg, params, ctx, tokens)

        lg_c = runs["cpu"][0]
        reordered = dataclasses.replace(ctx, attn_q_chunk=REORDER_CHUNK,
                                        attn_k_chunk=REORDER_CHUNK)
        lg_r = _prefill_logits(cfg, params, tokens, reordered, cpu,
                               sp_cpu)[0]                # the same plan
        del sp_cpu
        share = _outside_share("card vs cpu", lg_k, lg_c)
        noise = _outside_share(f"cpu (attention chunks of {REORDER_CHUNK}) vs "
                               f"cpu", lg_r, lg_c)
        shares[policy] = share
        print(f"  card vs cpu limit {100 * E2E_SHARE[policy]:.0f}% (the CPU's "
              f"own share under the reordered attention: {100 * noise:.3f}%)")
        check(share <= E2E_SHARE[policy], f"more than "
              f"{100 * E2E_SHARE[policy]:.0f}% of the prefill logits outside "
              f"rtol=0.05, atol=0.1 between card and cpu")
        if policy == "head":
            _check_head_on_one_hidden_state(cfg, params, ctx, tokens, dev)
        _check_tokens("card vs cpu", toks_k, "cpu", runs, cfg, params, ctx, tokens)
    return shares


def _outside_share(label, lg, ref) -> float:
    """The share of ``lg`` outside rtol=0.05, atol=0.1 of ``ref``, printed."""
    diff = (lg - ref).abs()
    outside = diff > 0.1 + 0.05 * ref.abs()
    share = float(outside.float().mean())
    print(f"  {label}: prefill logits max |d| {float(diff.max()):.4f}, mean |d| "
          f"{float(diff.mean()):.5f} (|logits| max {float(ref.abs().max()):.3f}); "
          f"{int(outside.sum())} of {outside.numel()} ({100 * share:.3f}%) "
          f"outside rtol=0.05, atol=0.1")
    return share


def _check_head_on_one_hidden_state(cfg, params, ctx, tokens, dev):
    """The LM head on the card (kernel 1 twice, kernel 5) and on the CPU
    (plain versions), both on the card's final hidden state: bitwise."""
    import torch
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        prepare_params_for_serving, serving_ctx)

    sctx = serving_ctx(ctx)
    sp = prepare_params_for_serving(params, cfg, ctx.plan, device=dev)
    with head_inputs() as seen:
        on_card = lm.prefill(sp, {"tokens": tokens.to(dev)}, cfg, sctx)[0]
    sp_cpu = prepare_params_for_serving(params, cfg, ctx.plan, device="cpu")
    on_cpu = lm.lm_logits(sp_cpu, seen[0].cpu(), cfg, sctx)[:, 0]
    same = torch.equal(on_card.cpu().view(torch.int32), on_cpu.view(torch.int32))
    print(f"  lm_head on the card's final hidden state: card (kernels 1, 5) vs "
          f"cpu (plain versions) bitwise {same}")
    check(same, "the LM head differs between card and cpu on one hidden state")


def _check_tokens(label, toks, ref_name, runs, cfg, params, ctx, prompts,
                  kv_format=None):
    """Greedy tokens must equal the reference run's; where one differs, the
    reference's top-2 logit gap at that step must be within the tolerance
    (``kv_format``: the serve's, where it overrides the policy's)."""
    import torch

    ref = runs[ref_name][1]
    print(f"  {label}: greedy tokens equal {torch.equal(toks, ref)}")
    for b in range(ref.shape[0]):
        idx = (toks[b] != ref[b]).nonzero()
        if not len(idx):
            continue
        step = int(idx[0])
        prompt = ({k: v[b:b + 1] for k, v in prompts.items()}
                  if isinstance(prompts, dict) else prompts[b:b + 1])
        top1, top2 = _top2(cfg, params, ctx, prompt, ref[b, :step],
                           runs[ref_name][2], plain=ref_name == "card-plain",
                           kv_format=kv_format)
        gap = top1 - top2
        print(f"  request {b}: first differing token at step {step}; "
              f"{ref_name} top-2 logit gap {gap:.4f}")
        check(gap <= 0.1 + 0.05 * abs(top1), f"request {b} diverges at step "
              f"{step} with a top-2 gap {gap} beyond the tolerance")


def _top2(cfg, params, ctx, prompt, emitted, device, *, plain: bool,
          kv_format=None):
    """The top two logits of a run at the step after the tokens ``emitted``
    (token 0 comes from the prefill logits); ``prompt`` token ids (1, S) or
    a prefill batch dict of one row."""
    import torch
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        ServeConfig, build_decode_cache, prepare_params_for_serving, serving_ctx)

    with plain_versions() if plain else contextlib.nullcontext():
        sp = prepare_params_for_serving(params, cfg, ctx.plan, device=device)
        sctx = serving_ctx(ctx)
        batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
        logits, cache = build_decode_cache(
            cfg, sp, {k: v.to(device) for k, v in batch.items()}, sctx,
            ServeConfig(max_new_tokens=len(emitted) + 1, kv_format=kv_format))
        for tok in emitted:
            logits, cache = lm.decode_step(
                sp, tok.reshape(1).to(device=device, dtype=torch.int32),
                cache, cfg, sctx)
    top = torch.topk(logits[0].float().cpu(), 2).values
    return float(top[0]), float(top[1])


# ---------------------------------------------------------------------------
# phase 6: the paged path
# ---------------------------------------------------------------------------

# 12 requests through 8 slots: a 256-token system prefix (4 pages) and tails
# of 32-224 tokens; request 2 is request 1 cut 16 tokens into its partial
# tail page (it shares that page, then its first append copies it). 24 pages
# are too few for every sequence's growth: the run evicts LRU pages and
# preempts. Lengths are multiples of the prefill flash chunk, so a prefix's
# K/V bytes do not depend on the prompt around it.
PAGED = {"page_tokens": 64, "new_tokens": 32, "decode_chunk": 8, "slots": 8,
         "prefix": 256, "tails": (224, 96, 160, 32, 192, 128, 64, 208, 144, 48,
                                  176), "kv_pages": 24, "flash_chunk": 16,
         # the first 4 of qwen1.5-0.5b's 24 layers: a cut for the script's
         # time (12 until phase train's part (f) came, 8 until phase examples
         # came; the scheduling depends on the prompts alone)
         "layers": 4}


def paged_requests(vocab: int, seed: int, tails=PAGED["tails"]) -> list:
    import torch

    g = torch.Generator().manual_seed(seed + 5)
    prefix = torch.randint(0, vocab, (PAGED["prefix"],), generator=g)
    reqs = [torch.cat([prefix, torch.randint(0, vocab, (n,), generator=g)])
            for n in tails]
    reqs.insert(2, reqs[1][: len(reqs[1]) - 16])
    return reqs


def _scaled(tree, f: float):
    """Every bf16 leaf times ``f``; a float32 leaf (a MoE router) keeps the
    init's scale (:func:`moe_paged_weights`)."""
    import torch

    if isinstance(tree, dict):
        return {k: _scaled(v, f) for k, v in tree.items()}
    return tree * f if tree.dtype == torch.bfloat16 else tree


def paged_weights(cfg, seed: int) -> dict:
    """The paged phase's raw weights on the host: the blocks and the
    embedding at 5x the init's scale, so greedy tokens change from step to
    step (at the init's scale they repeat one token) and a wrong KV byte
    shows in the tokens."""
    from repro_torch.models import lm

    params = lm.init_params(cfg, seed + 4, device="cpu")
    return dict(params, blocks=_scaled(params["blocks"], 5.0),
                embed=params["embed"] * 5.0)


def moe_paged_weights(cfg, seed: int, dev) -> dict:
    """A MoE config's paged weights, drawn on ``dev``: the experts at 5x the
    init's scale, so greedy tokens change from step to step; the embedding
    at 100x, so that each token's own embedding, not the attention's
    average over the prompt, steers the router. With router inputs alike
    across tokens, routing collapses onto a few experts and tokens overflow
    their capacity, which makes a prefix's K/V depend on the rest of its
    prompt (:func:`family_prefix_drops`). The router, the norms and the
    attention keep the init's scale."""
    from repro_torch.models import lm

    params = lm.init_params(cfg, seed + 4, device=dev, draw_on_device=True)
    blocks = dict(params["blocks"], moe=_scaled(params["blocks"]["moe"], 5.0))
    return dict(params, blocks=blocks, embed=params["embed"] * 100.0)


def preempt_recorder():
    """A fault injector that records the requests a run preempts and
    corrupts nothing."""
    from repro_torch.runtime.faults import FaultInjector, FaultSpec

    class Preempted(FaultInjector):
        def __init__(self):
            super().__init__(FaultSpec(kind="snapshot_truncation",
                                       target_request=-1))
            self.rids = []

        def poison_snapshot(self, pages, rid):
            self.rids.append(rid)
            return super().poison_snapshot(pages, rid)

    return Preempted()


def paged_ctx(cfg):
    t = PAGED
    return dataclasses.replace(serving_setup(cfg), attn_q_chunk=t["flash_chunk"],
                               attn_k_chunk=t["flash_chunk"])


def phase_paged(dev, seed, records):
    """The paged path at full width on ``PAGED["layers"]`` layers:
    serve_requests with the HiF4 page pool (kernel 4 for every layer of
    every decode step), held request by request against a solo serve at
    attn_kv_block = P."""
    from repro_torch.configs import get_arch
    from repro_torch.runtime.serve_loop import prepare_params_for_serving

    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"), n_layers=PAGED["layers"])
    ctx = paged_ctx(cfg)
    params = paged_weights(cfg, seed)
    sparams = prepare_params_for_serving(params, cfg, ctx.plan, device=dev)
    del params
    launches = paged_run(dev, cfg, sparams, ctx, paged_requests(cfg.vocab, seed))
    k4 = records.setdefault("fused_paged_decode_attention", {})
    k4["launches"] = launches["fused_paged_decode_attention"]
    k4.setdefault("ragged", {})["launches"] = k4["launches"]   # ragged tables
    records.setdefault("fused_decode_attention", {}).setdefault("solo", {})[
        "launches"] = launches["solo_fused_decode_attention"]


def paged_run(dev, cfg, sparams, ctx, reqs, solo=None) -> dict:
    """``reqs`` through the paged scheduler (``PAGED``'s slots, pool and
    chunks): the scheduler's counters, exact launches, and the tokens of the
    requests ``solo`` names (all by default; the preempted ones are added)
    equal to their solo serves at attn_kv_block = P. Returns the launches."""
    import torch
    from repro_torch.core import engine, kvcache
    from repro_torch.kernels import build
    from repro_torch.kernels.bfp_matmul import DECODE_M_MAX
    from repro_torch.runtime import serve_loop
    from repro_torch.runtime.serve_loop import ServeConfig, serve, serve_requests

    t = PAGED
    P, new = t["page_tokens"], t["new_tokens"]
    cap = max(len(r) for r in reqs) + new
    cap = -(-cap // P) * P
    a = cfg.attn
    page_bytes = kvcache.page_nbytes(a.n_kv_heads, a.d_head, P, cfg.n_layers)
    print(f"  {len(reqs)} requests (prompts {[len(r) for r in reqs]}) through "
          f"{t['slots']} slots; pool {t['kv_pages']} pages x {P} tokens = "
          f"{t['kv_pages'] * page_bytes} B ({page_bytes} B/page; whole-slot "
          f"equivalent {t['slots'] * cap // P * page_bytes} B)")
    sc = ServeConfig(max_new_tokens=new, decode_chunk=t["decode_chunk"],
                     cache_capacity=cap, kv_format="hif4", kv_pages=t["kv_pages"],
                     kv_page_tokens=P)
    counts = {"cow": 0, "steps": 0, "chunks": 0, "chunk_s": 0.0}
    copy, chunk_fn = serve_loop._pool_copy, serve_loop._decode_chunk

    def counting_copy(*args):
        counts["cow"] += 1
        return copy(*args)

    def timed_chunk(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = chunk_fn(*args)
        torch.cuda.synchronize()
        counts["chunk_s"] += time.perf_counter() - t0
        counts["chunks"] += 1
        counts["steps"] += args[4]
        return out

    linear, rows = engine._fused_packed_matmul, []

    def recording_linear(x, w, ectx):
        rows.append(x.numel() // x.shape[-1])
        return linear(x, w, ectx)

    serve_requests(cfg, sparams, reqs[:1], ctx,
                   dataclasses.replace(sc, max_new_tokens=2), device=dev)  # warm-up
    serve_loop._pool_copy, serve_loop._decode_chunk = counting_copy, timed_chunk
    engine._fused_packed_matmul = recording_linear
    preempted = preempt_recorder()
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        stats: dict = {}
        t0 = time.perf_counter()
        res = serve_requests(cfg, sparams, reqs, ctx, sc, slots=t["slots"],
                             stats=stats, device=dev, injector=preempted)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        serve_loop._pool_copy, serve_loop._decode_chunk = copy, chunk_fn
        engine._fused_packed_matmul = linear
    steps = counts["steps"]
    print(f"  paged run: {wall:.2f} s wall, {counts['chunks']} chunks of "
          f"{t['decode_chunk']} decode steps ({steps} steps), "
          f"{1e3 * counts['chunk_s'] / steps:.2f} ms per decode step of "
          f"{t['slots']} slots ({1e3 * counts['chunk_s'] / counts['chunks']:.1f} "
          f"ms per chunk); {card_line()}")
    print(f"  scheduler: max {stats['max_concurrent']} concurrent, "
          f"{stats['shared_page_hits']} shared-page hits, {counts['cow']} COW "
          f"copies, {stats['evictions']} LRU evictions, {stats['preemptions']} "
          f"preemptions of requests {preempted.rids} (snapshots restored), "
          f"peak {stats['peak_live_pages']}/"
          f"{t['kv_pages']} pages live, pool {stats['pool_bytes']} B, audit "
          f"{stats['pool_audit']}")
    check(stats["shared_page_hits"] >= 1 and counts["cow"] >= 1
          and stats["evictions"] >= 1 and stats["preemptions"] >= 1,
          "the paged run must show shared-prefix hits, a COW copy, an LRU "
          "eviction and a preemption")
    want4 = cfg.n_layers * steps
    print(f"  launches in the paged run: {launches} (fused_paged_decode_attention "
          f"and kv_append expected {cfg.n_layers} x {steps} = {want4}, "
          f"fused_decode_attention 0)")
    check(launches["fused_paged_decode_attention"] == want4
          and launches["kv_append"] == want4
          and launches["fused_decode_attention"] == 0,
          f"paged run launches {launches}")
    check({k for k, n in launches.items() if n} == {
        "hif4_quantize", "fused_packed_matmul", "fused_decode_matmul",
        "fused_paged_decode_attention", "kv_append"},
        f"paged run launched {launches}")
    # every packed linear of at most DECODE_M_MAX rows is one launch of the
    # decode form; a longer one (a prompt's prefill) kernel 1, then kernel 2
    decode = sum(r <= DECODE_M_MAX for r in rows)
    want = {"hif4_quantize": len(rows) - decode, "fused_packed_matmul": len(rows),
            "fused_decode_matmul": decode}
    got = {k: launches[k] for k in want}
    print(f"  packed linears in the paged run: {len(rows)} ({decode} of at most "
          f"{DECODE_M_MAX} rows, rows {sorted(set(rows))}); launches {got} "
          f"(expected {want})")
    check(got == want, f"paged run: launches {got} != expected {want}")
    solo_ctx = dataclasses.replace(ctx, attn_kv_block=P)
    solo_sc = ServeConfig(max_new_tokens=new, cache_capacity=cap, kv_format="hif4")
    ids = sorted(set(range(len(reqs)) if solo is None else solo)
                 | set(preempted.rids))
    differ = []
    for i in ids:
        one = serve(cfg, sparams, {"tokens": reqs[i][None]}, solo_ctx, solo_sc,
                    device=dev)[0].cpu()
        check(tuple(res[i].shape) == (new,), f"request {i}: shape {res[i].shape}")
        if not torch.equal(res[i], one):
            differ.append(i)
            print(f"  request {i}: paged {res[i].tolist()} != solo {one.tolist()}")
    n_distinct = len({tok for r in res for tok in r.tolist()})
    print(f"  paged == solo at attn_kv_block={P}: {len(ids) - len(differ)} of "
          f"requests {ids} equal ({n_distinct} distinct tokens; request 0: "
          f"{res[0].tolist()})")
    check(not differ, f"requests {differ}: paged tokens differ from solo")
    # the solo serves: kernel 3 at block_kv = P (the paged run launched none)
    launches["solo_fused_decode_attention"] = build.LAUNCHES[
        "fused_decode_attention"]
    print(f"  the {len(ids)} solo serves launched kernel 3 (block_kv={P}) "
          f"{launches['solo_fused_decode_attention']} times")
    return launches


# ---------------------------------------------------------------------------
# phase 8: serving artifacts, the guard, fault injection, crash recovery
# ---------------------------------------------------------------------------

# the fault runs' victim: request 3 owns tail pages no other request shares
# (request 2 shares request 1's tail page) and is resident from the first
# chunk on. A paged run at full depth takes ~35 s, most of it outside the
# decode chunks (admitting the 12 prompts), so the fault runs (step 3) are
# cut to the first ``fault_layers`` layers at full width; the artifact is
# served on two of the requests (paged == solo, so their tokens are the
# full run's)
ROBUST = {"victim": 3, "fault_layers": 2, "slot_requests": 4, "slot_slots": 2,
          "artifact_requests": (0, 3), "layers": 2}
# the phase's paged runs (artifact, guard, crash + resume) run the first
# ``layers`` of qwen1.5-0.5b's 24 at full width (24 until the train phase
# came, 6 until the scenario phase came, 3 until the non-dense families'
# training came; cut for the script's time: the paged schedule depends on
# the prompt lengths alone)


def _first_layers(tree, n: int):
    """The first ``n`` layers of a stacked-layer subtree (PackedW too)."""
    from repro_torch.core.qlinear import PackedW

    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    if isinstance(tree, PackedW):
        return tree._replace(codes=tree.codes[:n], meta=tree.meta[:n])
    return tree[:n]


class _SyncCount:
    """Counts the synchronize warnings of ``torch.cuda.set_sync_debug_mode``
    inside its block."""

    def __enter__(self):
        import warnings

        import torch

        self._catch = warnings.catch_warnings(record=True)
        self.records = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        self.n = sum("synchroniz" in str(w.message) for w in self.records)
        return False


def phase_robust(dev, seed, records):
    """The robustness slice on the paged path at full width (the paged
    phase's requests and pool, its weights on the first ``ROBUST["layers"]``
    layers): a serving artifact saved and loaded through the card, the
    guard (tokens, launches and synchronizes beside the unguarded run) and a
    crash resumed from its journal; the fault classes on the first
    ``ROBUST["fault_layers"]`` layers."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.core import kvcache
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.runtime import guard, serve_loop
    from repro_torch.runtime.faults import FaultInjector, FaultSpec, SimulatedCrash
    from repro_torch.runtime.serve_loop import (
        ServeConfig, load_serving_artifact, prepare_params_for_serving,
        save_serving_artifact, serve_requests)

    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"), n_layers=ROBUST["layers"])
    t = PAGED
    P, new = t["page_tokens"], t["new_tokens"]
    ctx = dataclasses.replace(serving_setup(cfg), attn_q_chunk=t["flash_chunk"],
                              attn_k_chunk=t["flash_chunk"])
    raw = paged_weights(cfg, seed)
    sparams = prepare_params_for_serving(raw, cfg, ctx.plan, device=dev)
    reqs = paged_requests(cfg.vocab, seed)
    cap = -(-(max(len(r) for r in reqs) + new) // P) * P
    sc = ServeConfig(max_new_tokens=new, decode_chunk=t["decode_chunk"],
                     cache_capacity=cap, kv_format="hif4", kv_pages=t["kv_pages"],
                     kv_page_tokens=P)
    gsc = dataclasses.replace(sc, guard=guard.GuardConfig())
    chunk_fns = {name: getattr(serve_loop, name)
                 for name in ("_decode_chunk", "_decode_chunk_guarded")}
    timing: list = []

    def timed(fn):
        # CUDA events around each chunk, read after the run: no synchronize
        # of their own inside the run
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            timing.append((start, end, args[5 if fn is chunk_fns[
                "_decode_chunk_guarded"] else 4]))
            return out
        return run

    def serve(params, scfg, reqs=reqs, slots=t["slots"], arch=cfg, **kw):
        stats: dict = {}
        res = serve_requests(arch, params, reqs, ctx, scfg, slots=slots,
                             stats=stats, device=dev, **kw)
        return res, stats

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    tmp = tempfile.mkdtemp(prefix=".robust-", dir=ROOT)
    try:
        # 1. artifact: saved from the raw weights (packed on the card), loaded
        #    back onto the card; served below beside the in-memory prepare
        art = os.path.join(tmp, "artifact")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_serving_artifact(art, raw, cfg, ctx.plan, device=dev)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(art) for f in fs)
        t0 = time.perf_counter()
        loaded, policy = load_serving_artifact(art, cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"  artifact: {nbytes} B on disk ({policy.name}); save "
              f"{save_s:.2f} s (packing on the card), load {load_s:.2f} s "
              f"(sha256 verified, then to the card)")
        check(policy.name == "paper-iv", f"artifact policy {policy.name}")

        # 2. the guard beside the unguarded run: tokens, launches, syncs, times
        serve(sparams, dataclasses.replace(sc, max_new_tokens=2), reqs[:1])
        runs = {}
        preempted = preempt_recorder()
        for name, scfg in (("unguarded", sc), ("guarded", gsc)):
            setattr(serve_loop, "_decode_chunk",
                    timed(chunk_fns["_decode_chunk"]))
            setattr(serve_loop, "_decode_chunk_guarded",
                    timed(chunk_fns["_decode_chunk_guarded"]))
            timing.clear()
            torch.cuda.synchronize()
            build.reset_launches()
            try:
                with _SyncCount() as syncs:
                    res, stats = serve(sparams, scfg, injector=(
                        preempted if scfg.guard is not None else None))
            finally:
                for fn_name, fn in chunk_fns.items():
                    setattr(serve_loop, fn_name, fn)
            torch.cuda.synchronize()
            steps = sum(n for _, _, n in timing)
            ms = sum(a.elapsed_time(b) for a, b, _ in timing)
            runs[name] = dict(res=res, stats=stats, launches=dict(build.LAUNCHES),
                              syncs=syncs.n, chunks=len(timing),
                              ms_step=ms / steps)
            print(f"  {name}: {ms / steps:.2f} ms per decode step ({len(timing)} "
                  f"chunks, {steps} steps), {syncs.n} synchronize warnings "
                  f"({syncs.n / len(timing):.1f} per chunk), launches "
                  f"{ {k: n for k, n in build.LAUNCHES.items() if n} }")
        plain, guarded = runs["unguarded"], runs["guarded"]
        base = guarded["res"]
        check(same(plain["res"], base), "guarded tokens differ from unguarded")
        check(all(r["status"] == "ok" for r in guarded["stats"]["reports"].values()),
              f"guarded reports {guarded['stats']['reports']}")
        check(guarded["stats"]["pool_audit"]["live"] == 0,
              f"pool audit {guarded['stats']['pool_audit']}")
        check(guarded["launches"] == plain["launches"],
              f"launches {guarded['launches']} != unguarded {plain['launches']}")
        check(guarded["syncs"] <= plain["syncs"],
              f"guarded run: {guarded['syncs']} synchronizes > {plain['syncs']}")
        check(guarded["stats"]["preemptions"] >= 1, "no preemption in the run")
        print(f"  guarded == unguarded tokens; decode {guarded['ms_step']:.2f} vs "
              f"{plain['ms_step']:.2f} ms/step; {card_line()}")
        picked = ROBUST["artifact_requests"]
        res, _ = serve(loaded, gsc, [reqs[i] for i in picked], len(picked))
        check(same(res, [base[i] for i in picked]), "the loaded artifact's "
              "tokens differ from the in-memory prepare's")
        print(f"  artifact served (requests {picked}): tokens bitwise the "
              "in-memory prepare's")
        leaves = tree_leaves(lm.realize_packed(
            lm.packed_overlay(lm.abstract_params(cfg), ctx.plan),
            lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta")))
        name = "['blocks']['attn']['wq']"
        index = next(i for i, (path, _, _) in enumerate(leaves)
                     if guard.keystr(path) == name)
        path = os.path.join(art, "step_00000000", f"arr_{index:05d}.npy")
        blob = bytearray(open(path, "rb").read())
        blob[-1] ^= 0x10
        open(path, "wb").write(bytes(blob))
        try:
            load_serving_artifact(art, cfg, device=dev)
            raise PhaseError("a flipped artifact byte loaded without an error")
        except guard.ArtifactIntegrityError as e:
            check(f"{name}: codes_sha256 mismatch" in str(e),
                  f"integrity error does not name {name}: {e}")
            print(f"  flipped byte in {os.path.basename(path)}: "
                  f"ArtifactIntegrityError names {name}")
        del loaded
        shutil.rmtree(art)

        # 3. faults, on the first layers: each caught by the guard the
        #    reference names; survivors bitwise the uninjected run
        victim = ROBUST["victim"]
        cut = dataclasses.replace(cfg, n_layers=ROBUST["fault_layers"])
        cparams = dict(sparams, blocks=_first_layers(sparams["blocks"],
                                                     cut.n_layers))
        cbase, _ = serve(cparams, gsc, arch=cut)
        print(f"  fault runs on the first {cut.n_layers} of {cfg.n_layers} "
              f"layers at full width")

        def contained(label, res, stats, inj, baseline, detector):
            rep = stats["reports"][victim]
            check(inj.fired, f"{label}: the fault never fired")
            check(rep["status"] in ("retried", "quarantined")
                  and rep["detail"].startswith(detector),
                  f"{label}: victim report {rep} (expected {detector})")
            ok = [i for i, r in stats["reports"].items() if r["status"] == "ok"]
            check(all(torch.equal(res[i], baseline[i]) for i in ok),
                  f"{label}: a survivor's tokens changed")
            print(f"  {label}: {inj.events[0][0]} on page/slot "
                  f"{inj.events[0][1].get('page', inj.events[0][1].get('slot'))}"
                  f" -> request {victim} {rep['status']} ({rep['detail']}); "
                  f"{len(ok)} survivors bitwise; counts "
                  f"{ {k: stats[k] for k in ('quarantined', 'retried', 'rejected')} }")

        for kind, seed_, detector in (("page_corruption", 1, "meta_nan"),
                                      ("code_flip", 0, "page_checksum")):
            inj = FaultInjector(FaultSpec(kind=kind, seed=seed_,
                                          target_request=victim, after_chunk=1))
            t0 = time.perf_counter()
            res, stats = serve(cparams, gsc, arch=cut, injector=inj)
            contained(f"{kind} ({time.perf_counter() - t0:.1f} s)", res, stats,
                      inj, cbase, detector)
        n_slot = ROBUST["slot_requests"]
        ssc = ServeConfig(max_new_tokens=new, decode_chunk=t["decode_chunk"],
                          cache_capacity=cap, kv_format="bf16",
                          guard=guard.GuardConfig())
        slot_base, _ = serve(cparams, ssc, reqs[:n_slot], ROBUST["slot_slots"],
                             arch=cut)
        inj = FaultInjector(FaultSpec(kind="nan_activation", target_request=victim,
                                      after_chunk=1))
        t0 = time.perf_counter()
        res, stats = serve(cparams, ssc, reqs[:n_slot], ROBUST["slot_slots"],
                           arch=cut, injector=inj)
        contained(f"nan_activation, slot scheduler, bf16 KV, {n_slot} requests "
                  f"({time.perf_counter() - t0:.1f} s)", res, stats, inj,
                  slot_base, "nan_logits")
        inj = FaultInjector(FaultSpec(kind="pool_starvation"))
        res, stats = serve(cparams, gsc, arch=cut, injector=inj)
        check(stats["rejected"] == len(reqs) and all(
            r["status"] == "rejected" for r in stats["reports"].values()),
            f"pool_starvation: {stats['reports']}")
        print(f"  pool_starvation: {stats['rejected']} of {len(reqs)} requests "
              f"rejected after {stats['reports'][0]['retries']} retries")

        # the paged schedule does not depend on the tokens: the cut run
        # preempts the request the guarded run preempted
        check(preempted.rids, "no preemption to corrupt")
        target = preempted.rids[0]
        inj = FaultInjector(FaultSpec(kind="snapshot_truncation", seed=0,
                                      target_request=target, bits=1))
        res, stats = serve(cparams, gsc, arch=cut, injector=inj)
        rep = stats["reports"][target]
        check(inj.fired and rep["status"] == "retried"
              and rep["detail"].startswith("snapshot_integrity")
              and stats["snapshot_drops"] >= 1, f"snapshot_truncation: {rep}")
        check(same(res, cbase), "snapshot_truncation: results not exact")
        print(f"  snapshot_truncation on request {target}'s preemption: "
              f"{rep['status']}, {stats['snapshot_drops']} snapshot dropped, "
              f"every result bitwise the uninjected run")

        # 4. crash mid-decode with a pool checkpoint every chunk, then resume
        jdir = os.path.join(tmp, "journal")
        jsc = dataclasses.replace(gsc, journal_dir=jdir, checkpoint_every=1)
        inj = FaultInjector(FaultSpec(kind="crash_mid_decode", after_chunk=1))
        try:
            serve(sparams, jsc, injector=inj)
            raise PhaseError("crash_mid_decode never fired")
        except SimulatedCrash:
            pass
        t0 = time.perf_counter()
        res, stats = serve(sparams, jsc, resume=True)
        resume_s = time.perf_counter() - t0
        rec = stats["recovery"]
        check(same(res, base), "resumed tokens differ from the uninterrupted run")
        check(rec["verified"] > 0, f"recovery verified nothing: {rec}")
        from repro_torch.runtime.journal import journal_residency
        print(f"  crash_mid_decode + resume: {rec['replayed']} replayed from the "
              f"checkpoint, {rec['re_prefilled']} re-prefilled, "
              f"{rec['completed']} completed, {rec['verified']} verified, "
              f"recovery {rec['recovery_ms']:.1f} ms (plan build), resumed serve "
              f"{resume_s:.1f} s; journal {journal_residency(jdir)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: the dense and MoE configs beyond qwen1.5-0.5b, at full width
# ---------------------------------------------------------------------------

FAMILY_BATCH, FAMILY_PROMPT = 8, 480
# (arch, layers or None for all, new tokens) of the lockstep serves:
# nemotron-4-340b at full width on its first 2 of 96 layers (its packed
# linears alone are ~186 GB); granite on 6 of its 24 layers, for the
# script's time (at full depth its serve took 24.6 s, 13.8 s more than on
# 12; NVIDIA H100 80GB HBM3, 700 W)
FAMILY_SERVES = (("qwen3-4b", 12, 32), ("granite-moe-1b-a400m", 6, 32),
                 ("nemotron-4-340b", 2, 8))
# the (K, N) each arch gives kernel 2 that qwen1.5-0.5b's path does not; at
# 8 rows nemotron's FFN down-projection (73728, 18432) runs kernel 1, then
# kernel 2's __dp4a body (its K range does not fit the decode form)
FAMILY_SHAPES = (("qwen3-4b", ((2560, 4096), (2560, 1024), (4096, 2560),
                               (2560, 9728), (9728, 2560))),
                 ("granite-moe-1b-a400m", ((1024, 512),)),
                 ("nemotron-4-340b", ((18432, 18432), (18432, 1536),
                                      (18432, 73728), (73728, 18432))))
# decode attention's new head layouts: (arch, Hkv, query heads, d_head,
# capacity of the lockstep serve)
FAMILY_ATTENTION = (("qwen3-4b", 8, 32, 128, 512),
                    ("granite-moe-1b-a400m", 8, 16, 64, 512),
                    ("nemotron-4-340b", 8, 96, 192, 488))
# granite's paged trace: the paged phase's shape with tails of 160-224
# tokens (prompts of 400-480). A token that overflows an expert's capacity
# changes the K/V of every later layer, and which tokens overflow depends
# on the whole prompt: the reference's capacity (1.25 x S x top-k /
# experts) grows with it, and positions count every token's earlier
# choices first. The pool then rightly refuses to share the pages that
# differ. Short prompts overflow more (family_prefix_drops prints it); on
# these prompts and moe_paged_weights, every prefix page and request 1's
# partial tail page are the same bytes under every prompt that holds them
# (measured on the card, seed 0). Request 2 (400) is request 1 (416) cut
# 16 tokens into its partial tail page (a slot's last page, 448-511, is
# never shared).
FAMILY_TAILS = (224, 160, 176, 192, 208, 160, 176, 224, 192, 208, 176)
# granite's paged run at full width on its first 2 of 24 layers (its first
# layers are the whole model's, so no prefix overflows there either; the
# scheduling depends on the prompts' lengths alone; 3 until the scenario
# phase came)
FAMILY_PAGED_LAYERS = 2
# requests held against their solo serves, with every preempted one:
# request 2 shares request 1's partial tail page and copies it (COW)
FAMILY_SOLO = (0, 1, 2)
# the e2e cut: granite at full width on 2 layers, batch 2, prompt 64
FAMILY_E2E = {"layers": 2, "batch": 2, "prompt": 64, "new": 8}
# greedy tokens of each full-width serve held against the plain versions'
# on the same weights (the prefill's token, then decode steps)
FAMILY_PLAIN_STEPS = 4


def _iters(bound_ms: float) -> int:
    """Timed calls of a measurement: ~200 for a call of microseconds, fewer
    (at least 5) as the call's bound grows."""
    return max(5, min(200, int(2.0 / max(bound_ms, 1e-4))))


def _bits(t):
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _row(t, plain_ms, bound, library_ms, **kw):
    """A kernel record's row at one shape: times, bound and yardstick; its
    launches are filled in by the serve that runs the shape."""
    bound_ms, bound_by, _ = bound
    return {**t, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "launches": 0, **kw}


def quantize_row(dev, gen, arch, mq, k, x, records, group="families"):
    """Kernel 1 on ``x`` (mq, k) bf16: bitwise its plain version, timed on
    copies that together overflow the L2; a row under ``group``."""
    import torch
    from repro_torch.kernels.hif4_quant import absorbed_activation, hif4_quantize

    ki, ks = hif4_quantize(x)
    pi, ps = absorbed_activation(x)
    torch.cuda.synchronize()
    check(torch.equal(ki, pi) and torch.equal(ks.view(torch.int32),
                                              ps.view(torch.int32)),
          f"hif4_quantize {arch} ({mq}, {k}): ints differ at "
          f"{int((ki != pi).sum())} positions, scales at "
          f"{int((ks.view(torch.int32) != ps.view(torch.int32)).sum())}")
    del ki, ks, pi, ps
    xs = [x] + [torch.randn(mq, k, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(-(-60 * 2 ** 20 // (mq * k * 2)) - 1)]
    bound_ms = _quantize_bound_ms(mq, k)
    t = timed(hif4_quantize, [(v,) for v in xs], iters=_iters(bound_ms))
    plain_ms = cuda_ms(absorbed_activation, [(x,)], iters=3, warmup=1)
    print(f"  hif4_quantize {arch} ({mq}, {k}) bf16: bitwise the plain "
          f"version; {_times(t)} plain_ms={plain_ms:.5f} bound_ms="
          f"{bound_ms:.6f} (bytes) library_ms=n/a (no single PyTorch call)")
    records.setdefault("hif4_quantize", {}).setdefault(group, []).append(
        {**t, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
         "library_ms": None, "launches": 0, "max_abs_err": 0.0, "arch": arch,
         "shape": f"x ({mq}, {k}) bf16",
         "counted_as": ("hif4_quantize", (mq, k))})
    del xs


def packed_shape_rows(dev, gen, arch, k, n, m, mp, quantized, records,
                      group="families"):
    """Kernel 2 at (K, N) in its decode route (the engine's: the decode form,
    or kernel 1 then the __dp4a body) at ``m`` rows and its prefill form at
    ``mp``, each bitwise its plain version and timed (kernel 1 at each new
    activation shape first); rows under ``group``. ``quantized`` holds the
    (M, K) kernel 1 already has rows for."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.qlinear import PackedW, QuantConfig
    from repro_torch.kernels.fused_matmul import (
        decode_plan, fused_decode_matmul_plain, fused_packed_matmul,
        fused_packed_matmul_plain)
    from repro_torch.kernels.hif4_quant import hif4_quantize

    ectx = engine.EngineCtx(QuantConfig(fmt="hif4", impl="packed"))

    def decode_route(x, pw):
        return engine.matmul(x, pw, ectx)

    def decode_plain(x, pw):
        return fused_decode_matmul_plain(x, pw.codes, pw.meta)

    w = (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    pw = PackedW.from_dense(w).to_kernel_layout()
    plan = decode_plan(m, k, n)
    # the decode route
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    if not plan.one_launch and (m, k) not in quantized:
        quantized.add((m, k))
        quantize_row(dev, gen, arch, m, k, x, records, group)
    y, ref = decode_route(x, pw), decode_plain(x, pw)
    torch.cuda.synchronize()
    check(torch.equal(_bits(y), _bits(ref)), f"{arch} decode M={m} K={k} "
          f"N={n}: not bitwise equal to the plain version at "
          f"{int((_bits(y) != _bits(ref)).sum())} outputs")
    rot = max(1, -(-60 * 2 ** 20 // (k * n * 9 // 16)))
    ws = [(pw, w)] + [(lambda v: (PackedW.from_dense(v).to_kernel_layout(),
                                  v))((torch.randn(k, n, generator=gen,
                                                   device=dev) * 0.02
                                       ).to(torch.bfloat16))
                      for _ in range(rot - 1)]
    bound = _decode_bound_ms(m, k, n)
    args = [(x, p) for p, _ in ws]
    t = timed(decode_route, args, iters=_iters(bound[0]))
    plain_ms = cuda_ms(decode_plain, args, iters=3, warmup=1)
    library_ms = cuda_ms(torch.matmul, [(x, v) for _, v in ws],
                         iters=_iters(bound[0]))
    name = "fused_decode_matmul" if plan.one_launch else "fused_packed_matmul"
    route = ("decode form" if plan.one_launch else
             "kernel 1, then the __dp4a body")
    print(f"  {arch} M={m} K={k} N={n} bf16 ({route}): bitwise the plain "
          f"version; {_times(t)} plain_ms={plain_ms:.5f} "
          f"bound_ms={bound[0]:.6f} ({bound[1]}) library_ms="
          f"{library_ms:.5f} (torch.matmul bf16 dense); {card_line()}")
    records.setdefault(name, {}).setdefault(group, []).append(_row(
        t, plain_ms, bound, library_ms, arch=arch, form=route,
        shape=f"M={m} K={k} N={n} bf16", counted_as=(name, (m, k, n))))
    # the prefill form
    xp = torch.randn(mp, k, generator=gen, device=dev).to(torch.bfloat16)
    if (mp, k) not in quantized:
        quantized.add((mp, k))
        quantize_row(dev, gen, arch, mp, k, xp, records, group)
    ai, asc = hif4_quantize(xp)
    y = fused_packed_matmul(ai, asc, pw.codes, pw.meta, torch.bfloat16)
    ref = fused_packed_matmul_plain(ai, asc, pw.codes, pw.meta, torch.bfloat16)
    torch.cuda.synchronize()
    check(torch.equal(_bits(y), _bits(ref)), f"{arch} prefill M={mp} K={k} "
          f"N={n}: not bitwise equal to the plain version")
    del y, ref
    bound = _prefill_bound_ms(mp, k, n)
    args = [(ai, asc, p.codes, p.meta, torch.bfloat16) for p, _ in ws[:2]]
    t = timed(fused_packed_matmul, args, iters=_iters(bound[0]))
    plain_ms = cuda_ms(fused_packed_matmul_plain, args[:1], iters=1, warmup=1)
    library_ms = cuda_ms(torch.matmul, [(xp, v) for _, v in ws[:2]],
                         iters=_iters(bound[0]))
    print(f"  {arch} M={mp} K={k} N={n} bf16 out (prefill form): bitwise "
          f"the plain version; {_times(t)} plain_ms={plain_ms:.5f} "
          f"bound_ms={bound[0]:.6f} ({bound[1]}) library_ms="
          f"{library_ms:.5f}")
    records.setdefault("fused_packed_matmul", {}).setdefault(group, []).append(
        _row(t, plain_ms, bound, library_ms, arch=arch, form="prefill form",
             shape=f"M={mp} K={k} N={n} bf16 out",
             counted_as=("fused_packed_matmul", (mp, k, n))))
    del ws, args, w, pw, x, xp, ai, asc
    torch.cuda.empty_cache()


def family_kernels(dev, records):
    """Kernel 1 on the new activation shapes (each new K at 3 840 rows, and
    nemotron's 73 728 at 8), kernel 2 at the new shapes, in its decode route
    (the engine's: the decode form, or kernel 1 then the __dp4a body) at 8
    rows and its prefill form at 3 840, each bitwise its plain version and
    timed; kernels 3 and 4 at the new head layouts within rtol 2^-7, atol
    1e-3 of theirs (kernel 4 bitwise kernel 3 at block_kv = P), timed. Each
    row goes to its kernel's record under "families"; the serves fill in
    its launches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kvcache
    from repro_torch.kernels.fused_attention import (
        fused_paged_decode_attention, fused_paged_decode_attention_plain)

    gen = torch.Generator(device=dev).manual_seed(21)
    m, mp = FAMILY_BATCH, FAMILY_BATCH * FAMILY_PROMPT
    quantized = {(mp, 1024)}            # check_quantize's prefill shape

    for arch, shapes in FAMILY_SHAPES:
        for k, n in shapes:
            packed_shape_rows(dev, gen, arch, k, n, m, mp, quantized, records)

    cpu_gen = torch.Generator().manual_seed(22)
    for arch, hkv, h, d, cap in FAMILY_ATTENTION:
        attention_row(dev, cpu_gen, arch, m, hkv, h, d, cap,
                      [1, 63, 64, 65, cap, cap - 1, 2, cap], records)

    # kernel 4 at granite's layout on the paged phase's ragged table
    hkv, h, d, P = 8, 16, 64, PAGED["page_tokens"]
    pools = [tuple(_paged_pool(PAGED["kv_pages"], P, hkv, d, cpu_gen, dev)
                   for _ in range(2)) for _ in range(L2_ROTATION)]
    q = (torch.randn(m, h, d, generator=cpu_gen) * 0.5).to(torch.bfloat16).to(dev)
    pages = torch.tensor(RAGGED_TABLE, dtype=torch.int32, device=dev)
    length = torch.tensor(RAGGED_LENGTH, dtype=torch.int32, device=dev)
    err = _compare_paged(q, *pools[0], pages, length, hkv, d, P,
                         f"granite Hkv={hkv} H={h} D={d} ragged table")
    args = [(q, kp, vp, pages, length) for kp, vp in pools]
    t = timed(lambda *a: fused_paged_decode_attention(*a, n_kv_heads=hkv,
                                                      d_head=d), args, iters=100)
    plain_ms = cuda_ms(lambda *a: fused_paged_decode_attention_plain(
        *a, hkv, d), args, iters=5)
    bound_ms = attention_bound_ms(hkv, d, length, pages, P, heads=h)
    dense = []
    for kp, vp in pools:
        kd, vd = (kvcache.dequantize_kv(_contiguous_from_pages(c, pages), hkv, d)
                  .transpose(1, 2).repeat_interleave(h // hkv, 1)
                  for c in (kp, vp))
        dense.append((q[:, :, None], kd, vd))
    library_ms = cuda_ms(F.scaled_dot_product_attention, dense, iters=100)
    print(f"  fused_paged_decode_attention granite B={m} Hkv={hkv} H={h} D={d} "
          f"P={P}, ragged table: {_times(t)} plain_ms={plain_ms:.5f} "
          f"bound_ms={bound_ms:.6f} (bytes) library_ms={library_ms:.5f} "
          f"(scaled_dot_product_attention on the gathered, dequantized bf16 "
          f"K/V, not the same function)")
    del dense
    records.setdefault("fused_paged_decode_attention", {}).setdefault(
        "families", []).append({**t, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": "bytes", "library_ms": library_ms,
                                "arch": "granite-moe-1b-a400m", "launches": 0,
                                "counted_as": ("fused_paged_decode_attention",),
                                "max_abs_err": err,
                                "shape": f"B={m} Hkv={hkv} H={h} D={d} P={P} "
                                         f"ragged table"})


def attention_row(dev, cpu_gen, arch, m, hkv, h, d, cap, lengths, records,
                  group="families", label=""):
    """Kernel 3 on a packed cache of ``cap`` slots at ``lengths`` within
    rtol 2^-7, atol 1e-3 of its plain version, then timed with every slot
    full (L2-cold rotation) beside its bound and SDPA on the dequantized
    K/V; a row under ``group``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import kvcache
    from repro_torch.kernels.fused_attention import (
        fused_decode_attention, fused_decode_attention_plain)

    caches = [_packed_cache(m, cap, hkv, d, cpu_gen, dev)
              for _ in range(L2_ROTATION)]
    q = (torch.randn(m, h, d, generator=cpu_gen) * 0.5).to(torch.bfloat16).to(dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = fused_decode_attention(q, *caches[0], length, n_kv_heads=hkv, d_head=d)
    ref = fused_decode_attention_plain(q, *caches[0], length, hkv, d)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    check(bool((err <= 1e-3 + 2 ** -7 * ref.float().abs()).all()),
          f"fused_decode_attention {arch} Hkv={hkv} H={h} D={d} S={cap}: max "
          f"|d| {float(err.max())} beyond rtol=2^-7, atol=1e-3")
    full = torch.full((m,), cap, dtype=torch.int32, device=dev)
    args = [(q, pk, pv, full) for pk, pv in caches]
    t = timed(lambda *a: fused_decode_attention(*a, n_kv_heads=hkv, d_head=d),
              args, iters=100)
    plain_ms = cuda_ms(lambda *a: fused_decode_attention_plain(*a, hkv, d),
                       args, iters=5)
    rep = h // hkv
    dense = [(q[:, :, None], *(kvcache.dequantize_kv(c, hkv, d).transpose(1, 2)
                               .repeat_interleave(rep, 1) for c in (pk, pv)))
             for pk, pv in caches]
    library_ms = cuda_ms(F.scaled_dot_product_attention, dense, iters=100)
    bound_ms = attention_bound_ms(hkv, d, full, None, cap, heads=h)
    print(f"  fused_decode_attention {arch}{label} B={m} Hkv={hkv} H={h} D={d} "
          f"S={cap}: max |d| {float(err.max()):.3e} vs plain; {_times(t)} "
          f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} (bytes) "
          f"library_ms={library_ms:.5f} (SDPA on the dequantized K/V)")
    records.setdefault("fused_decode_attention", {}).setdefault(
        group, []).append({**t, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": "bytes", "library_ms": library_ms,
                           "arch": arch, "counted_as": ("fused_decode_attention",),
                           "launches": 0, "max_abs_err": float(err.max()),
                           "shape": f"B={m} Hkv={hkv} H={h} D={d} S={cap}{label}"})
    del caches, dense, args


def _packed_shapes(sparams, collection="blocks") -> list:
    """(K, N) of each packed linear of one layer (a PackedW leaf each) of a
    stacked collection."""
    from repro_torch.core.qlinear import PackedW

    def walk(node):
        if isinstance(node, PackedW):
            return [node.shape2d]
        if isinstance(node, dict):
            return [s for v in node.values() for s in walk(v)]
        return []

    return walk(sparams[collection])


def expected_launches(cfg, shapes, steps, m, mp, attention_layers=None
                      ) -> tuple[dict, dict]:
    """The launches (all, and per (kernel, shape)) of a lockstep serve:
    per layer each packed linear once at the prefill's ``mp`` rows (kernel
    1, then kernel 2) and once per decode step at ``m`` rows (the decode
    form, or where its plan says so kernel 1 then kernel 2); kernel 3 and
    the KV append (K and V in one launch) once per attention layer
    (default: every layer) and step."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_matmul import decode_plan

    L = cfg.n_layers
    want = dict.fromkeys(build.LAUNCHES, 0)
    per: dict = {}

    def add(kernel, mkn, n):
        want[kernel] += n
        if mkn is not None:
            per[(kernel, mkn)] = per.get((kernel, mkn), 0) + n

    for k, n in shapes:
        add("hif4_quantize", (mp, k), L)
        add("fused_packed_matmul", (mp, k, n), L)
        if decode_plan(m, k, n).one_launch:
            add("fused_decode_matmul", (m, k, n), L * steps)
            add("fused_packed_matmul", None, L * steps)
        else:
            add("hif4_quantize", (m, k), L * steps)
            add("fused_packed_matmul", (m, k, n), L * steps)
    appends = (L if attention_layers is None else attention_layers) * steps
    want["fused_decode_attention"] = appends
    if appends:
        add("kv_append", (m, cfg.attn.n_kv_heads, cfg.attn.d_head, 2, False),
            appends)
    return want, per


def family_weights(cfg, seed: int, dev) -> dict:
    """A full-width serve's raw weights, drawn on ``dev``: the blocks (but a
    MoE router, float32; the SSM's f32 A, dt bias and skip), the hybrid's
    shared block, the audio encoder's blocks and the embedding at 5x the
    init's scale, scaled in place,
    as :func:`paged_weights` scales them. At the init's scale every request
    repeats one token, and a wrong byte does not show in the tokens."""
    import torch
    from repro_torch.models import lm

    params = lm.init_params(cfg, seed + 4, device=dev, draw_on_device=True)

    def scale(node):
        if isinstance(node, dict):
            for v in node.values():
                scale(v)
        elif node.dtype == torch.bfloat16:
            node.mul_(5.0)

    scale(params["blocks"])
    scale(params.get("shared", {}))
    scale(params.get("enc_blocks", {}))
    scale(params["embed"])
    return params


def greedy_steps(cfg, sparams, batch, ctx, new, steps):
    """The first ``steps`` greedy tokens (B, steps) of a lockstep serve of
    the prefill inputs ``batch`` for ``new`` tokens (its cache capacity),
    and each step's logits (f32, on the host): the serve loop's own prefill
    and decode steps."""
    import torch
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        ServeConfig, build_decode_cache, serving_ctx)

    sctx = serving_ctx(ctx)
    logits, cache = build_decode_cache(cfg, sparams, batch, sctx,
                                       ServeConfig(max_new_tokens=new))
    toks, lgs = [], []
    for i in range(steps):
        lgs.append(logits.float().cpu())
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
        if i + 1 < steps:
            logits, cache = lm.decode_step(sparams, toks[-1], cache, cfg, sctx)
    return torch.stack(toks, dim=1).cpu(), lgs


def check_against_plain(arch, cfg, sparams, batch, ctx, new, served) -> None:
    """The served tokens against the plain versions' on the same weights,
    ``FAMILY_PLAIN_STEPS`` steps: the kernels' prefill logits bitwise the
    plain versions', the kernels' steps the served run's tokens, and where
    a plain token differs, the plain run's top-2 logit gap at that step
    within rtol=0.05, atol=0.1 (kernel 3 is not bitwise its plain
    version)."""
    import torch

    n = FAMILY_PLAIN_STEPS
    with plain_versions():
        toks_p, lg_p = greedy_steps(cfg, sparams, batch, ctx, new, n)
    toks_k, lg_k = greedy_steps(cfg, sparams, batch, ctx, new, n)
    check(torch.equal(toks_k, served[:, :n].cpu()), f"{arch}: the kernels' "
          f"first {n} steps differ from the served tokens")
    same = torch.equal(lg_k[0].view(torch.int32), lg_p[0].view(torch.int32))
    print(f"  kernels vs plain versions, same weights: prefill logits bitwise "
          f"{same}; first {n} greedy tokens equal {torch.equal(toks_k, toks_p)}")
    check(same, f"{arch}: prefill logits of the kernels != the plain versions'")
    for b in range(toks_p.shape[0]):
        idx = (toks_k[b] != toks_p[b]).nonzero()
        if not len(idx):
            continue
        step = int(idx[0])
        top = torch.topk(lg_p[step][b], 2).values
        gap = float(top[0] - top[1])
        print(f"  request {b}: first differing token at step {step}; plain "
              f"top-2 logit gap {gap:.4f}")
        check(gap <= 0.1 + 0.05 * abs(float(top[0])), f"{arch}: request {b} "
              f"diverges from the plain versions at step {step} with a top-2 "
              f"gap {gap} beyond the tolerance")


def family_serve(dev, seed, arch, layers, new, records, group="families"
                 ) -> None:
    """A lockstep serve of ``arch`` at full width (its first ``layers``
    layers where given): paper-iv, impl packed, HiF4 KV, batch 8, prompt
    480 (token ids, or the vlm's f32 embeds), or for the audio family
    ``ENC_FRAMES`` f32 frames (the decoder starts from BOS), weights drawn
    on the card from ``seed`` (:func:`family_weights`); exact launches per
    kernel and per shape; prefill ms, decode ms/step, tokens/s; tokens that
    vary within every request; the first steps against the plain versions
    (:func:`check_against_plain`). Fills in the launches of the kernel rows
    under ``group``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import kvcache
    from repro_torch.core.qlinear import PACK_SLAB_VALUES, PackedW
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prefill_batch
    from repro_torch.runtime.serve_loop import (
        ServeConfig, packed_weight_bytes, prepare_params_for_serving, serve)

    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    audio = cfg.family == "audio"
    m, prompt = FAMILY_BATCH, ENC_FRAMES if audio else FAMILY_PROMPT
    ctx = serving_setup(cfg)
    if audio:
        ctx = dataclasses.replace(ctx, attn_k_chunk=ENC_K_CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = family_weights(cfg, seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if "mlp" in raw["blocks"] and "wi" in raw["blocks"]["mlp"]:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        wi = raw["blocks"]["mlp"]["wi"][0]
        one = PackedW.from_dense(wi)
        torch.cuda.synchronize()
        print(f"  packing one mlp.wi {tuple(wi.shape)} on the card: peak "
              f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.2f} GiB "
              f"above the {base / 2 ** 30:.2f} GiB resident (slabs of "
              f"{PACK_SLAB_VALUES} values; the "
              f"weight itself {wi.numel() * 2 / 2 ** 30:.2f} GiB in bf16)")
        del one, wi
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sparams = prepare_params_for_serving(raw, cfg, ctx.plan, device=dev)
    del raw
    torch.cuda.synchronize()
    print(f"  {arch}: {cfg.n_layers} layers"
          + (f" (and {cfg.enc_layers} encoder layers)" if audio else "")
          + f", d_model {cfg.d_model}; weights "
          f"drawn on the card from seed {seed} in {init_s:.1f} s, prepared in "
          f"{time.perf_counter() - t0:.1f} s (peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated)")
    nbytes, nvals = packed_weight_bytes(sparams)
    check(nvals and nbytes / nvals == 0.5625, "packed weights are not 0.5625 "
          "B/value")
    shapes = _packed_shapes(sparams)
    dense_bytes = sum(t.numel() * t.element_size()
                      for t in sparams["blocks"].get("moe", {}).values())
    print(f"  packed weight residency: {nbytes / 1e6:.1f} MB for {nvals} values "
          f"(linears per layer {shapes})" + (
              f"; MoE router and experts unpacked: {dense_bytes / 1e6:.1f} MB"
              if dense_bytes else "") + (
              f"; encoder linears per layer {_packed_shapes(sparams, 'enc_blocks')}"
              if audio else ""))
    a = cfg.attn
    per_tok = kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head, 'hif4') * cfg.n_layers
    print(f"  kv bytes per token: {per_tok} B (bf16: "
          f"{kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head, 'bf16') * cfg.n_layers}"
          f" B)" + (f"; the read-only cross cache {per_tok * prompt * m / 1e6:.2f} "
                    f"MB for {m} x {prompt} frames" if audio else ""))
    batch = prefill_batch(cfg, m, prompt, seed + 1, dev)
    serve(cfg, sparams, {k: v[:, :64] for k, v in batch.items()}, ctx,
          ServeConfig(max_new_tokens=2), device=dev)          # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    stats: dict = {}
    with attention_capacities() as caps:
        toks = serve(cfg, sparams, batch, ctx, ServeConfig(max_new_tokens=new),
                     device=dev, stats=stats)
        torch.cuda.synchronize()
    launches, per_shape = dict(build.LAUNCHES), dict(build.SHAPE_LAUNCHES)
    steps = stats["decode_steps"]
    what = "frames (encoder), BOS (decoder)" if audio else (
        "embeds" if cfg.embeds_input else "tokens")
    print(f"  prefill {stats['prefill_s'] * 1e3:.1f} ms for {m} x {prompt} "
          f"{what}; decode {stats['decode_s'] * 1e3 / steps:.2f} ms/step "
          f"({m * steps / stats['decode_s']:.1f} tokens/s over {steps} steps); "
          f"{card_line()}")
    if audio:
        want, want_shapes = encdec_expected(cfg, sparams, steps, m, m * prompt)
    else:
        want, want_shapes = expected_launches(cfg, shapes, steps, m, m * prompt)
    print(f"  launches: {launches} (expected {want})")
    check(launches == want, f"{arch}: launch counts {launches} != {want}")
    print(f"  launches per (kernel, (M, K, N)): {per_shape}")
    check(per_shape == want_shapes, f"{arch}: launches per shape {per_shape} "
          f"!= {want_shapes}")
    print(f"  kernel 3 launches per cache capacity: {caps}")
    check(sum(caps.values()) == launches["fused_decode_attention"],
          f"{arch}: kernel 3 calls by capacity {caps} != its launches")
    for rec in records.values():
        for r in rec.get(group, []):
            if r["arch"] == arch:
                kernel, *mkn = r["counted_as"]
                r["launches"] = (caps.get(r["capacity"], 0) if "capacity" in r
                                 else per_shape.get((kernel, tuple(mkn[0])), 0)
                                 if mkn else launches[kernel])
    check(tuple(toks.shape) == (m, new), f"tokens shape {tuple(toks.shape)}")
    rows = {tuple(r) for r in toks.tolist()}
    print(f"  {len(rows)} distinct token rows of {m}; request 0: "
          f"{toks[0].tolist()}")
    check(len(rows) > 1, f"{arch}: every request gave the same tokens")
    _check_tokens_vary(arch, toks.cpu())
    check_against_plain(arch, cfg, sparams,
                        {k: v.to(dev) for k, v in batch.items()}, ctx, new, toks)


@contextlib.contextmanager
def attention_capacities():
    """Count the engine's kernel 3 calls per cache capacity (the audio
    decoder's self and cross caches): {capacity: calls}."""
    from repro_torch.core import engine, kvcache

    seen: dict = {}
    fused = engine.fused_decode_attention

    def recording(q, k, v, length, **kw):
        cap = kvcache.seq_capacity(k)
        seen[cap] = seen.get(cap, 0) + 1
        return fused(q, k, v, length, **kw)

    engine.fused_decode_attention = recording
    try:
        yield seen
    finally:
        engine.fused_decode_attention = fused


def family_prefix_drops(dev, cfg, sparams, ctx, seed) -> None:
    """Why granite's paged trace keeps its prompts long: the paged trace's
    prefix under a 32-token and a 224-token tail, prefilled alone: the
    prefix tokens that overflow an expert per layer, and whether the two
    prefixes' K/V are bitwise equal, at the reference's capacity and with
    the capacity lifted (no drops)."""
    import torch
    from repro_torch.models import lm, moe
    from repro_torch.runtime.serve_loop import serving_ctx

    n = PAGED["prefix"]
    short, long_ = paged_requests(cfg.vocab, seed, (32, 224))[:2]
    capacity, positions = moe.capacity, moe._positions
    for lifted in (False, True):
        drops = {}

        def counting(idx, E):
            pos = positions(idx, E)
            C = moe.capacity(cfg, idx.shape[1])
            drops.setdefault(idx.shape[1], []).append(int((pos[:, :n] >= C).sum()))
            return pos

        kv = []
        moe._positions = counting
        if lifted:
            moe.capacity = lambda c, s: 4 * s * c.moe.top_k
        try:
            for r in (short, long_):
                kv.append(lm.prefill(sparams, {"tokens": r[None].to(dev)}, cfg,
                                     serving_ctx(ctx))[1]["kv"])
        finally:
            moe.capacity, moe._positions = capacity, positions
        same = all(torch.equal(kv[0][key][:, :, :n], kv[1][key][:, :, :n])
                   for key in ("k", "v"))
        print(f"  prefix of {n} tokens under prompts of {len(short)} / "
              f"{len(long_)} tokens{' (capacity lifted)' if lifted else ''}: "
              f"prefix tokens dropped per layer {drops[len(short)]} / "
              f"{drops[len(long_)]}; prefix K/V bitwise equal {same}")
        if lifted:
            check(same, "without drops, a prefix's K/V depend on what follows it")


def family_paged(dev, seed, records):
    """Granite through the paged scheduler at full width on its first
    ``FAMILY_PAGED_LAYERS`` layers: the paged phase's pool and chunks on
    ``FAMILY_TAILS``; paged equals solo for ``FAMILY_SOLO`` and every
    preempted request.

    The trace and its weights were chosen on ``--seed`` 0, where no prefix
    token overflows an expert under any prompt that holds it. Another seed
    is not supported here: a prefix may overflow there, its pages then
    differ under another prompt while the pool shares them by their
    tokens, and paged == solo may fail (:func:`family_prefix_drops` prints
    the drops first)."""
    from repro_torch.configs import get_arch
    from repro_torch.runtime.serve_loop import prepare_params_for_serving

    full = get_arch("granite-moe-1b-a400m")
    cfg = dataclasses.replace(full, n_layers=FAMILY_PAGED_LAYERS)
    ctx = paged_ctx(cfg)
    raw = moe_paged_weights(full, seed, dev)
    raw = dict(raw, blocks=_first_layers(raw["blocks"], cfg.n_layers))
    sparams = prepare_params_for_serving(raw, cfg, ctx.plan, device=dev)
    del raw
    family_prefix_drops(dev, cfg, sparams, ctx, seed)
    launches = paged_run(dev, cfg, sparams, ctx,
                         paged_requests(cfg.vocab, seed, FAMILY_TAILS),
                         solo=FAMILY_SOLO)
    for r in records.get("fused_paged_decode_attention", {}).get("families", []):
        r["launches"] = launches["fused_paged_decode_attention"]


def _routes(seen):
    """The chosen experts of each recorded route() call, as sorted sets."""
    import torch

    return [torch.sort(idx, dim=-1).values.cpu() for idx in seen]


@contextlib.contextmanager
def recorded_routes():
    """Record the expert indices each moe route() call chooses."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def recording(*a, **kw):
        gates, idx = route(*a, **kw)
        seen.append(idx)
        return gates, idx

    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = route


def family_e2e(dev, seed):
    """Granite at full width on 2 layers, one set of weights (drawn on the
    card, copied to the host): served on the card through the kernels, on
    the card through the plain versions (prefill logits bitwise equal), and
    on the CPU: the share of prefill logits outside rtol=0.05, atol=0.1
    (at most 1%, as for paper-iv dense), and the tokens whose chosen expert
    set differs from the CPU's."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        ServeConfig, build_decode_cache, prepare_params_for_serving, serve,
        serving_ctx)

    t = FAMILY_E2E
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m"),
                              n_layers=t["layers"])
    params = _map_tensors(lm.init_params(cfg, seed + 2, device=dev,
                                         draw_on_device=True), lambda x: x.cpu())
    gen = torch.Generator().manual_seed(seed + 3)
    tokens = torch.randint(0, cfg.vocab, (t["batch"], t["prompt"]), generator=gen)
    sc = ServeConfig(max_new_tokens=t["new"])
    ctx = serving_setup(cfg)
    cpu = torch.device("cpu")
    runs = {}

    def run(name, d):
        sp = prepare_params_for_serving(params, cfg, ctx.plan, device=d)
        with recorded_routes() as seen:
            lg, _ = build_decode_cache(cfg, sp, {"tokens": tokens.to(d)},
                                       serving_ctx(ctx), sc)
        toks = serve(cfg, sp, {"tokens": tokens}, ctx, sc, device=d)
        runs[name] = (lg.float().cpu(), toks.cpu(), d, _routes(seen))

    build.reset_launches()
    run("card", dev)
    ran = {k for k, n in build.LAUNCHES.items() if n}
    check(ran == {"hif4_quantize", "fused_packed_matmul", "fused_decode_matmul",
                  "fused_decode_attention", "kv_append"}, f"the card run "
          f"launched {build.LAUNCHES}")
    with plain_versions():
        run("card-plain", dev)
    run("cpu", cpu)
    lg_k, toks_k, _, r_k = runs["card"]
    lg_p, toks_p, _, r_p = runs["card-plain"]
    lg_c, _, _, r_c = runs["cpu"]
    print(f"  card kernels vs card plain versions: prefill logits bitwise "
          f"{torch.equal(lg_k, lg_p)}, expert choices equal "
          f"{all(torch.equal(a, b) for a, b in zip(r_k, r_p))}, greedy tokens "
          f"equal {torch.equal(toks_k, toks_p)}")
    check(torch.equal(lg_k, lg_p), "prefill logits: kernels != plain versions")
    _check_tokens("card kernels vs card plain", toks_k, "card-plain", runs, cfg,
                  params, ctx, tokens)
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(r_k, r_c))
    n_tok = sum(a.shape[0] * a.shape[1] for a in r_k)
    print(f"  card vs cpu: {flips} of {n_tok} token routings (layers x batch x "
          f"prompt) chose another expert set in the prefill")
    share = _outside_share("card vs cpu", lg_k, lg_c)
    check(share <= E2E_SHARE["paper-iv"], f"more than "
          f"{100 * E2E_SHARE['paper-iv']:.0f}% of the prefill logits outside "
          f"rtol=0.05, atol=0.1 between card and cpu ({flips} routing flips)")
    _check_tokens("card vs cpu", toks_k, "cpu", runs, cfg, params, ctx, tokens)


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree)


def phase_families(dev, seed, records):
    """The configs of the dense and MoE families the main path does not
    serve: the new shapes of kernels 1-4 against their plain versions;
    qwen3-4b at full width and depth, granite-moe-1b-a400m and nemotron-
    4-340b at full width on their FAMILY_SERVES layers, lockstep, each
    against the plain versions for its first steps; granite through the
    paged scheduler; the expert einsums' device time per step; granite's
    e2e cut card vs CPU."""
    import torch
    from repro_torch.launch import profile

    t0 = time.perf_counter()

    def part(label):
        print(f"  -- {label} (at {time.perf_counter() - t0:.1f} s)")

    family_kernels(dev, records)
    for arch, layers, new in FAMILY_SERVES:
        part(arch)
        family_serve(dev, seed, arch, layers, new, records)
        torch.cuda.empty_cache()
    part("python -m repro_torch.launch.profile --arch granite-moe-1b-a400m "
         "--steps 4")
    profile.main(["--arch", "granite-moe-1b-a400m", "--steps", "4", "--top",
                  "8", "--seed", str(seed)])
    torch.cuda.empty_cache()
    part("granite-moe-1b-a400m e2e cut")
    family_e2e(dev, seed)
    torch.cuda.empty_cache()
    part("granite-moe-1b-a400m paged")
    family_paged(dev, seed, records)
    part("done")


# ---------------------------------------------------------------------------
# phase 10: the Mamba2 SSM and hybrid families
# ---------------------------------------------------------------------------

SSM_BATCH, SSM_PROMPT = 8, 512      # the prompt a multiple of the SSD chunk
# (arch, impl, layers (None: all), new tokens): lockstep serves at full
# width, mamba2 on 16 of its 48 layers and zamba2 on 18 of 54 (3 calls of
# the shared block), for the script's time (full depth until the scenario
# phase came, which serves mamba2-1.3b at full depth; 24 and 30 until the
# non-dense families' training came)
SSM_SERVES = (("mamba2-1.3b", "packed", 16, 32),
              ("zamba2-2.7b", "pallas", 18, 32))
# (K, N) of mamba2's six packed linears (w_z / w_x, w_b / w_c, w_dt, w_out)
SSM_PACKED_SHAPES = ((2048, 4096), (2048, 128), (2048, 64), (4096, 2048))
# the e2e cut: mamba2 at full width on 2 layers, batch 2, prompt 64
SSM_E2E = {"layers": 2, "batch": 2, "prompt": 64, "new": 8}


def dense_sites(cfg) -> list:
    """(K, N, calls per forward) of every 2-D dense linear of a hybrid
    forward that runs the pallas route: the six Mamba linears of each of
    the n_layers blocks; the shared block's q, k, v, o projections (reshaped
    to 2-D) and its MLP, once per group."""
    d, s, a = cfg.d_model, cfg.ssm, cfg.attn
    di = s.expand * d
    L, ns = cfg.n_layers, cfg.n_layers // cfg.hybrid_attn_every
    sites = {}

    def add(k, n, c):
        sites[(k, n)] = sites.get((k, n), 0) + c

    add(d, di, 2 * L)
    add(d, s.n_groups * s.d_state, 2 * L)
    add(d, di // s.head_dim, L)
    add(di, d, L)
    add(d, a.n_heads * a.d_head, ns)
    add(d, a.n_kv_heads * a.d_head, 2 * ns)
    add(a.n_heads * a.d_head, d, ns)
    add(d, cfg.d_ff, ns)
    add(cfg.d_ff, d, ns)
    return [(k, n, c) for (k, n), c in sites.items()]


def dense_expected(cfg, steps, m, mp) -> tuple[dict, dict]:
    """The launches of a lockstep serve under impl pallas with no packed
    weight: per dense site call, kernel 1 on x and on w.T then kernel 5's
    tensor-core body at the prefill's ``mp`` rows; kernel 1 on x, then
    kernel 5's decode form at each step's ``m`` rows."""
    from repro_torch.kernels import build

    want = dict.fromkeys(build.LAUNCHES, 0)
    per: dict = {}

    def add(kernel, shape, c):
        want[kernel] += c
        if shape is not None:
            per[(kernel, shape)] = per.get((kernel, shape), 0) + c

    for k, n, c in dense_sites(cfg):
        add("hif4_quantize", (mp, k), c)
        add("hif4_quantize", (n, k), c)
        add("bfp_matmul_quantized", (mp, k, n), c)
        add("hif4_quantize", (m, k), c * steps)
        add("bfp_decode_matmul", (m, k, n), c * steps)
        add("bfp_matmul_quantized", None, c * steps)
    return want, per


def dense_shape_rows(dev, gen, arch, k, n, m, mp, quantized, records,
                     group="ssm"):
    """Kernel 5 at a dense (K, N) the pallas route runs: at ``mp`` rows
    kernel 1 on x and on w.T, then the tensor-core body; at ``m`` rows
    kernel 1 on x, then the decode form (Algorithm 1 on the bf16 weight in
    its loader); each bitwise its plain version and timed beside its bound
    and torch.matmul bf16; kernel 1 at each new shape first."""
    import torch
    from repro_torch.kernels.bfp_matmul import (
        bfp_decode_matmul, bfp_decode_matmul_plain, bfp_matmul_quantized,
        bfp_matmul_quantized_plain)
    from repro_torch.kernels.hif4_quant import hif4_quantize

    w = (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    xp = torch.randn(mp, k, generator=gen, device=dev).to(torch.bfloat16)
    for mq, kq, v in ((mp, k, xp), (n, k, w.T.contiguous())):
        if (mq, kq) not in quantized:
            quantized.add((mq, kq))
            quantize_row(dev, gen, arch, mq, kq, v, records, group)
    ai, asc = hif4_quantize(xp)
    ws = [w] + [(torch.randn(k, n, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16) for _ in range(max(1, -(-60 * 2 ** 20 // (k * n * 2))) - 1)]
    qw = [hif4_quantize(v.T.contiguous()) for v in ws[:2]]
    y = bfp_matmul_quantized(ai, asc, qw[0][0].T, qw[0][1].T)
    ref = bfp_matmul_quantized_plain(ai, asc, qw[0][0].T, qw[0][1].T)
    torch.cuda.synchronize()
    check(torch.equal(_bits(y), _bits(ref)), f"{arch} bfp_matmul_quantized "
          f"M={mp} K={k} N={n}: not bitwise its plain version at "
          f"{int((_bits(y) != _bits(ref)).sum())} outputs")
    del y, ref
    bound = _group_matmul_bound_ms(mp, k, n)
    args = [(ai, asc, wi.T, wsc.T) for wi, wsc in qw]
    t = timed(bfp_matmul_quantized, args, iters=_iters(bound[0]))
    plain_ms = cuda_ms(bfp_matmul_quantized_plain, args[:1], iters=1, warmup=1)
    library_ms = cuda_ms(torch.matmul, [(xp, v) for v in ws[:2]],
                         iters=_iters(bound[0]))
    print(f"  {arch} bfp_matmul_quantized M={mp} K={k} N={n} (tensor-core "
          f"body): bitwise the plain version; {_times(t)} plain_ms="
          f"{plain_ms:.5f} bound_ms={bound[0]:.6f} ({bound[1]}) library_ms="
          f"{library_ms:.5f} (torch.matmul bf16)")
    records.setdefault("bfp_matmul_quantized", {}).setdefault(group, []).append(
        _row(t, plain_ms, bound, library_ms, arch=arch, form="tensor-core body",
             shape=f"M={mp} K={k} N={n} f32 out",
             counted_as=("bfp_matmul_quantized", (mp, k, n))))
    del args, qw, ai, asc
    # the decode form
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    if (m, k) not in quantized:
        quantized.add((m, k))
        quantize_row(dev, gen, arch, m, k, x, records, group)
    ai, asc = hif4_quantize(x)
    y, ref = bfp_decode_matmul(ai, asc, w), bfp_decode_matmul_plain(ai, asc, w)
    torch.cuda.synchronize()
    check(torch.equal(_bits(y), _bits(ref)), f"{arch} bfp_decode_matmul M={m} "
          f"K={k} N={n}: not bitwise its plain version at "
          f"{int((_bits(y) != _bits(ref)).sum())} outputs")
    bound = _head_decode_bound_ms(m, k, n)
    args = [(ai, asc, v) for v in ws]
    t = timed(bfp_decode_matmul, args, iters=_iters(bound[0]))
    plain_ms = cuda_ms(bfp_decode_matmul_plain, args[:1], iters=2, warmup=1)
    library_ms = cuda_ms(torch.matmul, [(x, v) for v in ws],
                         iters=_iters(bound[0]))
    print(f"  {arch} bfp_decode_matmul M={m} K={k} N={n} bf16 weight (decode "
          f"form): bitwise the plain version; {_times(t)} plain_ms="
          f"{plain_ms:.5f} bound_ms={bound[0]:.6f} ({bound[1]}) library_ms="
          f"{library_ms:.5f} (torch.matmul bf16); {card_line()}")
    records.setdefault("bfp_decode_matmul", {}).setdefault(group, []).append(
        _row(t, plain_ms, bound, library_ms, arch=arch, form="decode form",
             shape=f"M={m} K={k} N={n} bf16 weight",
             counted_as=("bfp_decode_matmul", (m, k, n))))
    del ws, args, w, x, xp, ai, asc
    torch.cuda.empty_cache()


def ssm_kernels(dev, records):
    """The shapes the SSM and hybrid serves give the kernels: mamba2's six
    packed linears through kernel 2 (decode form at 8 rows, prefill form at
    4 096) and zamba2's dense linears through kernel 5 (decode form at 8,
    tensor-core body at 4 096), kernel 1 at each new activation and w.T
    shape; every row bitwise its plain version, timed, under "ssm"."""
    import torch
    from repro_torch.configs import get_arch

    gen = torch.Generator(device=dev).manual_seed(23)
    m, mp = SSM_BATCH, SSM_BATCH * SSM_PROMPT
    quantized: set = set()
    for k, n in SSM_PACKED_SHAPES:
        packed_shape_rows(dev, gen, "mamba2-1.3b", k, n, m, mp, quantized,
                          records, group="ssm")
    for k, n, _ in dense_sites(get_arch("zamba2-2.7b")):
        dense_shape_rows(dev, gen, "zamba2-2.7b", k, n, m, mp, quantized, records)


def ssm_serve(dev, seed, arch, impl, layers, new, records) -> None:
    """A lockstep serve of ``arch`` at full width (its first ``layers``
    layers where given): paper-iv under ``impl``, HiF4 KV requested (the
    family falls back to bf16 with one KVFallbackWarning), batch 8, prompt
    512, weights drawn on the card from ``seed`` (:func:`family_weights`);
    exact launches per kernel and per shape; prefill ms, decode ms/step,
    tokens/s; tokens that vary within every request; the first steps
    against the plain versions (:func:`check_against_plain`)."""
    import warnings

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.models.params import spec_leaves
    from repro_torch.runtime.serve_loop import (
        KVFallbackWarning, ServeConfig, kv_format_fallback,
        packed_weight_bytes, prepare_params_for_serving, serve)

    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    m, prompt = SSM_BATCH, SSM_PROMPT
    ctx = serving_setup(cfg, impl=impl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = family_weights(cfg, seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sparams = prepare_params_for_serving(raw, cfg, ctx.plan, device=dev)
    torch.cuda.synchronize()
    print(f"  {arch} ({cfg.family}, impl {impl}): {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}; weights drawn on the card from seed {seed} "
          f"in {init_s:.1f} s, prepared in {time.perf_counter() - t0:.1f} s "
          f"(peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"allocated)")
    nbytes, nvals = packed_weight_bytes(sparams)
    # serve prepares what it is given: a packed tree as it is, raw weights
    # into the offline-QDQ artifact (applying the offline QDQ to an already
    # QDQ'd tree would quantize those weights twice), as the launcher does
    served = sparams if nvals else raw
    del raw
    shapes = _packed_shapes(sparams)
    if impl == "packed":
        check(nvals and nbytes / nvals == 0.5625, "packed weights are not "
              "0.5625 B/value")
        print(f"  packed weight residency: {nbytes / 1e6:.1f} MB for {nvals} "
              f"values (linears per layer {shapes})")
    else:
        check(nvals == 0, f"{arch} packed {nvals} values; the reference packs "
              f"nothing of the hybrid family")
        dense = sum(t.numel() * t.element_size() for t in _tensor_leaves(sparams))
        print(f"  no packed weights resident: {dense / 1e6:.1f} MB of dense "
              f"weights (every 2-D linear quantized per call by kernel 1)")
    cache_spec = lm.abstract_cache(cfg, m, prompt + new, "hif4")
    cache_bytes = sum(math.prod(p.shape) * p.dtype.itemsize
                      for _, p in spec_leaves(cache_spec))
    print(f"  decode cache at batch {m}, capacity {prompt + new}: "
          f"{cache_bytes / 1e6:.1f} MB ({', '.join(sorted(cache_spec))}; "
          f"SSM state f32, conv windows and any KV bf16)")
    sc = ServeConfig(max_new_tokens=new)
    check(kv_format_fallback(cfg, ctx.quant, sc), f"{arch}: hif4 KV was not "
          f"narrowed to bf16")
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (m, prompt), generator=gen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", KVFallbackWarning)
        serve(cfg, served, {"tokens": tokens[:, :64]}, ctx,
              ServeConfig(max_new_tokens=2), device=dev)      # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    stats: dict = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        toks = serve(cfg, served, {"tokens": tokens}, ctx, sc, device=dev,
                     stats=stats)
    torch.cuda.synchronize()
    launches, per_shape = dict(build.LAUNCHES), dict(build.SHAPE_LAUNCHES)
    fallbacks = [str(w.message) for w in caught
                 if issubclass(w.category, KVFallbackWarning)]
    print(f"  KVFallbackWarning x {len(fallbacks)}: {fallbacks[:1]}")
    check(len(fallbacks) == 1, f"{arch}: {len(fallbacks)} fallback warnings "
          f"in one serve call")
    steps = stats["decode_steps"]
    print(f"  prefill {stats['prefill_s'] * 1e3:.1f} ms for {m} x {prompt} "
          f"tokens; decode {stats['decode_s'] * 1e3 / steps:.2f} ms/step "
          f"({m * steps / stats['decode_s']:.1f} tokens/s over {steps} steps); "
          f"{card_line()}")
    if impl == "packed":
        want, want_shapes = expected_launches(cfg, shapes, steps, m, m * prompt,
                                              attention_layers=0)
    else:
        want, want_shapes = dense_expected(cfg, steps, m, m * prompt)
    print(f"  launches: {launches} (expected {want})")
    check(launches == want, f"{arch}: launch counts {launches} != {want}")
    print(f"  launches per (kernel, shape): {per_shape}")
    check(per_shape == want_shapes, f"{arch}: launches per shape {per_shape} "
          f"!= {want_shapes}")
    for rec in records.values():
        for r in rec.get("ssm", []):
            if r["arch"] == arch:
                kernel, *mkn = r["counted_as"]
                r["launches"] = (per_shape.get((kernel, tuple(mkn[0])), 0)
                                 if mkn else launches[kernel])
    check(tuple(toks.shape) == (m, new), f"tokens shape {tuple(toks.shape)}")
    rows = {tuple(r) for r in toks.tolist()}
    print(f"  {len(rows)} distinct token rows of {m}; request 0: "
          f"{toks[0].tolist()}")
    check(len(rows) > 1, f"{arch}: every request gave the same tokens")
    _check_tokens_vary(arch, toks.cpu())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", KVFallbackWarning)
        check_against_plain(arch, cfg, sparams, {"tokens": tokens.to(dev)}, ctx,
                            new, toks)


def _tensor_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    return [tree]


def ssm_e2e(dev, seed):
    """mamba2 at full width on 2 layers, one set of weights (drawn on the
    card, copied to the host), paper-iv packed: served on the card through
    the kernels, on the card through the plain versions (prefill logits
    bitwise equal, tokens equal), and on the CPU: at most 1% of the prefill
    logits outside rtol=0.05, atol=0.1, the greedy tokens equal."""
    import warnings

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        KVFallbackWarning, ServeConfig, build_decode_cache,
        prepare_params_for_serving, serve, serving_ctx)

    t = SSM_E2E
    cfg = dataclasses.replace(get_arch("mamba2-1.3b"), n_layers=t["layers"])
    params = _map_tensors(lm.init_params(cfg, seed + 2, device=dev,
                                         draw_on_device=True), lambda x: x.cpu())
    gen = torch.Generator().manual_seed(seed + 3)
    tokens = torch.randint(0, cfg.vocab, (t["batch"], t["prompt"]), generator=gen)
    sc = ServeConfig(max_new_tokens=t["new"])
    ctx = serving_setup(cfg)
    runs = {}

    def run(name, d):
        sp = prepare_params_for_serving(params, cfg, ctx.plan, device=d)
        lg, _ = build_decode_cache(cfg, sp, {"tokens": tokens.to(d)},
                                   serving_ctx(ctx), sc)
        toks = serve(cfg, sp, {"tokens": tokens}, ctx, sc, device=d)
        runs[name] = (lg.float().cpu(), toks.cpu())

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", KVFallbackWarning)
        build.reset_launches()
        run("card", dev)
        ran = {k for k, n in build.LAUNCHES.items() if n}
        check(ran == {"hif4_quantize", "fused_packed_matmul",
                      "fused_decode_matmul"}, f"the card run launched "
              f"{build.LAUNCHES}")
        with plain_versions():
            run("card-plain", dev)
        run("cpu", torch.device("cpu"))
    lg_k, toks_k = runs["card"]
    lg_p, toks_p = runs["card-plain"]
    lg_c, toks_c = runs["cpu"]
    print(f"  card kernels vs card plain versions: prefill logits bitwise "
          f"{torch.equal(lg_k, lg_p)}, greedy tokens equal "
          f"{torch.equal(toks_k, toks_p)}")
    check(torch.equal(lg_k, lg_p), "prefill logits: kernels != plain versions")
    check(torch.equal(toks_k, toks_p), "tokens: kernels != plain versions")
    share = _outside_share("card vs cpu", lg_k, lg_c)
    check(share <= E2E_SHARE["paper-iv"], f"more than "
          f"{100 * E2E_SHARE['paper-iv']:.0f}% of the prefill logits outside "
          f"rtol=0.05, atol=0.1 between card and cpu")
    print(f"  card vs cpu greedy tokens equal {torch.equal(toks_k, toks_c)}; "
          f"card request 0: {toks_k[0].tolist()}")
    check(torch.equal(toks_k, toks_c), "greedy tokens: card != cpu")


def phase_ssm(dev, seed, records):
    """The SSM (mamba2-1.3b) and hybrid (zamba2-2.7b) families: kernels 1, 2
    and 5 at their new shapes against the plain versions; both at full
    width and depth, lockstep (mamba2 impl packed, zamba2 impl pallas),
    each against the plain versions for its first steps; mamba2's e2e cut
    card vs CPU; mamba2's decode step profiled."""
    import torch
    from repro_torch.launch import profile

    t0 = time.perf_counter()

    def part(label):
        print(f"  -- {label} (at {time.perf_counter() - t0:.1f} s)")

    ssm_kernels(dev, records)
    for arch, impl, layers, new in SSM_SERVES:
        part(f"{arch} impl {impl}")
        ssm_serve(dev, seed, arch, impl, layers, new, records)
        torch.cuda.empty_cache()
    part("mamba2-1.3b e2e cut")
    ssm_e2e(dev, seed)
    torch.cuda.empty_cache()
    part("python -m repro_torch.launch.profile --arch mamba2-1.3b --steps 4")
    profile.main(["--arch", "mamba2-1.3b", "--steps", "4", "--top", "8",
                  "--seed", str(seed)])
    torch.cuda.empty_cache()
    part("done")


# ---------------------------------------------------------------------------
# phase 11: the Whisper encoder-decoder and the LLaVA-NeXT backbone
# ---------------------------------------------------------------------------

# whisper's encoder frames: the reference's ENC_FRAMES_DECODE (1 536; the 30 s
# window's 1 500 divides no attention chunk), with KV chunks of 512 (the
# default 1 024 does not divide 1 536)
ENC_FRAMES, ENC_K_CHUNK = 1536, 512
# (arch, layers or None for all, new tokens) of the lockstep serves:
# llava-next-34b at full width on its first 4 of 60 layers (its 60 layers'
# raw bf16, ~66.9 GB, and their packed copy do not fit the card together;
# 8 until the scenario phase came, cut for the script's time)
ENCDEC_SERVES = (("whisper-tiny", None, 32), ("llava-next-34b", 4, 32))
# the (K, N) each arch gives kernel 2, and its prefill rows
ENCDEC_SHAPES = (("whisper-tiny", FAMILY_BATCH * ENC_FRAMES,
                  ((384, 384), (384, 1536), (1536, 384))),
                 ("llava-next-34b", FAMILY_BATCH * FAMILY_PROMPT,
                  ((7168, 7168), (7168, 1024), (7168, 20480), (20480, 7168))))
# kernel 3's new caches: (arch, Hkv, query heads, d_head, capacity, lengths
# of the bitwise check, label): whisper's self cache (BOS + 32 new tokens:
# one tile, ck % 4 != 0) and its read-only cross cache (every slot full);
# llava's 56 heads on 8 (a group of 7)
ENCDEC_ATTENTION = (
    ("whisper-tiny", 6, 6, 64, 33, [1, 2, 17, 32, 33, 33, 5, 9], " self"),
    ("whisper-tiny", 6, 6, 64, ENC_FRAMES, [ENC_FRAMES] * 8, " cross"),
    ("llava-next-34b", 8, 56, 128, FAMILY_PROMPT + 32,
     [1, 63, 64, 65, 512, 511, 2, 480], ""))
# whisper's e2e cut: full depth, batch 2, 8 new tokens, the init's weights
# (as every e2e cut); the serve's 5x weights are read too, not bounded
ENCDEC_E2E = {"batch": 2, "new": 8}


def encdec_expected(cfg, sparams, steps, m, mp) -> tuple[dict, dict]:
    """The launches of an audio lockstep serve: kernel 1, then kernel 2's
    prefill form, for each encoder linear at the frames' ``mp`` rows and
    for the cross K and V of each decoder layer (the encoder output,
    projected once); the decode form for each decoder linear (self q, k, v,
    o; cross q, o; the MLP's two) on BOS and at each step, ``m`` rows;
    kernel 3 for the self and the cross cache of each layer and step, the
    KV append for the self cache only."""
    from repro_torch.kernels import build

    a, d, L, E = cfg.attn, cfg.d_model, cfg.n_layers, cfg.enc_layers
    q, kv = a.n_heads * a.d_head, a.n_kv_heads * a.d_head
    enc = [(d, q), (d, kv), (d, kv), (q, d), (d, cfg.d_ff), (cfg.d_ff, d)]
    dec = enc[:4] + [(d, q), (q, d)] + enc[4:]
    check(sorted(_packed_shapes(sparams, "enc_blocks")) == sorted(enc)
          and sorted(_packed_shapes(sparams)) == sorted(dec + [(d, kv)] * 2),
          "the packed linears are not whisper's")
    want = dict.fromkeys(build.LAUNCHES, 0)
    per: dict = {}

    def add(kernel, mkn, n):
        want[kernel] += n
        if mkn is not None:
            per[(kernel, mkn)] = per.get((kernel, mkn), 0) + n

    for (k, n), c in [(s, E) for s in enc] + [((d, kv), 2 * L)]:
        add("hif4_quantize", (mp, k), c)
        add("fused_packed_matmul", (mp, k, n), c)
    for k, n in dec:
        add("fused_decode_matmul", (m, k, n), L * (1 + steps))
        add("fused_packed_matmul", None, L * (1 + steps))
    want["fused_decode_attention"] = 2 * L * steps
    add("kv_append", (m, a.n_kv_heads, a.d_head, 2, False), L * steps)
    return want, per


def encdec_kernels(dev, records):
    """Kernel 1 at each new activation shape, kernel 2 at whisper's and
    llava's (K, N) in its decode form at 8 rows and its prefill form at the
    serve's prefill rows (12 288 frames, 3 840 embeds), each bitwise its
    plain version, and kernel 3 at the new caches within rtol 2^-7, atol
    1e-3 of its plain version, all timed; rows under "encdec"."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(24)
    quantized: set = set()
    for arch, mp, shapes in ENCDEC_SHAPES:
        for k, n in shapes:
            packed_shape_rows(dev, gen, arch, k, n, FAMILY_BATCH, mp, quantized,
                              records, group="encdec")
    cpu_gen = torch.Generator().manual_seed(25)
    for arch, hkv, h, d, cap, lengths, label in ENCDEC_ATTENTION:
        attention_row(dev, cpu_gen, arch, FAMILY_BATCH, hkv, h, d, cap, lengths,
                      records, group="encdec", label=label)
        if arch == "whisper-tiny":      # its serve's launches split by cache
            records["fused_decode_attention"]["encdec"][-1]["capacity"] = cap


def encdec_e2e(dev, seed):
    """whisper-tiny at full width and depth, one set of weights at the init's
    scale (drawn on the card, copied to the host) and frames at batch 2:
    served on the card through the kernels, on the card through the plain
    versions (prefill logits bitwise equal), and on the CPU: at most 1% of
    the prefill logits outside rtol=0.05, atol=0.1; the greedy tokens
    compared. Then the prefill logits card vs CPU at the serve's 5x weights,
    printed and not bounded: there every attention score is 25x the init's,
    the encoder's softmax over 1 536 frames picks its key by the last bit
    of a float op, and PyTorch's CPU and CUDA ops differ in that bit."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prefill_batch
    from repro_torch.runtime.serve_loop import (
        ServeConfig, build_decode_cache, prepare_params_for_serving, serve,
        serving_ctx)

    from repro_torch.models import lm

    t = ENCDEC_E2E
    cfg = get_arch("whisper-tiny")
    params = _map_tensors(lm.init_params(cfg, seed + 2, device=dev,
                                         draw_on_device=True), lambda x: x.cpu())
    frames = prefill_batch(cfg, t["batch"], ENC_FRAMES, seed + 3, dev)
    frames = {k: v.cpu() for k, v in frames.items()}
    sc = ServeConfig(max_new_tokens=t["new"])
    ctx = dataclasses.replace(serving_setup(cfg), attn_k_chunk=ENC_K_CHUNK)
    runs = {}

    def run(name, d):
        sp = prepare_params_for_serving(params, cfg, ctx.plan, device=d)
        batch = {k: v.to(d) for k, v in frames.items()}
        lg, _ = build_decode_cache(cfg, sp, batch, serving_ctx(ctx), sc)
        toks = serve(cfg, sp, batch, ctx, sc, device=d)
        runs[name] = (lg.float().cpu(), toks.cpu(), d)

    build.reset_launches()
    run("card", dev)
    ran = {k for k, n in build.LAUNCHES.items() if n}
    check(ran == {"hif4_quantize", "fused_packed_matmul", "fused_decode_matmul",
                  "fused_decode_attention", "kv_append"}, f"the card run "
          f"launched {build.LAUNCHES}")
    with plain_versions():
        run("card-plain", dev)
    run("cpu", torch.device("cpu"))
    lg_k, toks_k, _ = runs["card"]
    lg_p, toks_p, _ = runs["card-plain"]
    lg_c, toks_c, _ = runs["cpu"]
    print(f"  card kernels vs card plain versions: prefill logits bitwise "
          f"{torch.equal(lg_k, lg_p)}, greedy tokens equal "
          f"{torch.equal(toks_k, toks_p)}")
    check(torch.equal(lg_k, lg_p), "prefill logits: kernels != plain versions")
    _check_tokens("card kernels vs card plain", toks_k, "card-plain", runs, cfg,
                  params, ctx, frames)
    share = _outside_share("card vs cpu", lg_k, lg_c)
    check(share <= E2E_SHARE["paper-iv"], f"more than "
          f"{100 * E2E_SHARE['paper-iv']:.0f}% of the prefill logits outside "
          f"rtol=0.05, atol=0.1 between card and cpu")
    print(f"  card request 0: {toks_k[0].tolist()}; cpu request 0: "
          f"{toks_c[0].tolist()}")
    _check_tokens("card vs cpu", toks_k, "cpu", runs, cfg, params, ctx, frames)
    scaled = _map_tensors(family_weights(cfg, seed + 2, dev), lambda x: x.cpu())
    logits = []
    for d in (dev, torch.device("cpu")):
        sp = prepare_params_for_serving(scaled, cfg, ctx.plan, device=d)
        logits.append(build_decode_cache(
            cfg, sp, {k: v.to(d) for k, v in frames.items()}, serving_ctx(ctx),
            sc)[0].float().cpu())
    _outside_share("card vs cpu at the serve's 5x weights (not bounded)",
                   *logits)


def phase_encdec(dev, seed, records):
    """The audio encoder-decoder (whisper-tiny) and the vlm (llava-next-34b):
    kernels 1-3 at their new shapes against the plain versions; whisper at
    full width and depth on 1 536 frames and llava at full width on its
    first 4 of 60 layers on 480-token embeds, lockstep, each against the
    plain versions for its first steps; whisper's e2e cut card vs CPU."""
    import torch

    t0 = time.perf_counter()

    def part(label):
        print(f"  -- {label} (at {time.perf_counter() - t0:.1f} s)")

    encdec_kernels(dev, records)
    for arch, layers, new in ENCDEC_SERVES:
        part(arch)
        family_serve(dev, seed, arch, layers, new, records, group="encdec")
        torch.cuda.empty_cache()
    part("whisper-tiny e2e cut")
    encdec_e2e(dev, seed)
    torch.cuda.empty_cache()
    part("done")


CALIBRATE = {"arch": "qwen1.5-0.5b", "n_batches": 2, "batch": 2, "seq_len": 64,
             "errors_rtol": 2e-2, "higptq_bound": 1.25, "targets":
             ("sensitive-fallback", 0.7), "new_tokens": 32}
CALIBRATE_OUT = ROOT / ".calibrate"


def _calibration_batches(cfg, seed):
    """The reference's calibration set: ``n_batches`` prefill batches of
    (batch, seq_len) token ids from ``seed + i``, on the host."""
    from repro_torch.launch.serve import prefill_batch

    return [prefill_batch(cfg, CALIBRATE["batch"], CALIBRATE["seq_len"],
                          seed + i, "cpu") for i in range(CALIBRATE["n_batches"])]


def _site_rows(summary) -> dict:
    return {r["path"]: r for r in summary["report"]["sites"]}


def _check_higptq_bound(label, summary) -> None:
    """Every packable captured site's HiGPTQ error within 1.25x its direct
    cast's (the reference's bound, tests/test_calibrate.py)."""
    for path, r in _site_rows(summary).items():
        if r["packable"] and r["captured"]:
            e = r["errors"]
            check(0 < e["hif4"] <= CALIBRATE["higptq_bound"] * e["hif4_direct"],
                  f"{label}: {path}: HiGPTQ error {e['hif4']} above "
                  f"{CALIBRATE['higptq_bound']} x the direct cast's "
                  f"{e['hif4_direct']}")


def calibrate_card_vs_cpu(dev, seed) -> None:
    """(a) reduced qwen1.5-0.5b calibrated on the card and on the CPU, the
    same weights and batches, at the fallback preset's bytes: the same
    assignment and bytes, every per-site error within rtol 2e-2."""
    from repro_torch.calibrate import calibrate
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    cfg = get_arch(CALIBRATE["arch"]).reduced()
    params = lm.init_params(cfg, seed, device="cpu")
    batches = _calibration_batches(cfg, seed)
    runs = {}
    for where in ("cpu", dev):
        t0 = time.perf_counter()
        runs[str(where)] = calibrate(
            CALIBRATE["arch"], reduced=True, target_bpv="sensitive-fallback",
            seed=seed, params=_map_tensors(params, lambda t: t.to(where)),
            batches=batches, device=where, log=lambda *_: None)
        print(f"  reduced {cfg.name} on {where}: {time.perf_counter() - t0:.2f} s "
              f"({runs[str(where)]['n_packed']} of {runs[str(where)]['n_sites']} "
              f"sites packed, {runs[str(where)]['total_bytes']} B)")
    cpu, card = runs["cpu"], runs[str(dev)]
    check(card["assignment"] == cpu["assignment"], f"reduced: card assignment "
          f"{card['assignment']} != the CPU's {cpu['assignment']}")
    check(card["total_bytes"] == cpu["total_bytes"], "reduced: card bytes "
          f"{card['total_bytes']} != the CPU's {cpu['total_bytes']}")
    worst = 0.0
    cpu_rows = _site_rows(cpu)
    for path, r in _site_rows(card).items():
        if r["errors"] is None:
            check(cpu_rows[path]["errors"] is None, f"reduced: {path} scored "
                  f"on the CPU only")
            continue
        for fmt, e in r["errors"].items():
            ref = cpu_rows[path]["errors"][fmt]
            rel = abs(e - ref) / max(abs(ref), 1e-30)
            worst = max(worst, rel)
            check(rel <= CALIBRATE["errors_rtol"], f"reduced: {path} {fmt} "
                  f"error {e} on the card vs {ref} on the CPU")
    print(f"  card vs CPU: assignment and bytes equal; per-site errors within "
          f"rel {worst:.2e} (limit {CALIBRATE['errors_rtol']})")
    _check_higptq_bound("reduced card", card)


def calibrate_full(dev, seed, raw) -> dict:
    """(b) qwen1.5-0.5b at full width and depth calibrated on the card at
    each of ``CALIBRATE["targets"]``: feasible, verified, the curve's bytes
    falling strictly, and at the fallback preset's bytes the search no worse
    than the preset in bytes or error. Returns {target: summary}."""
    import torch
    from repro_torch.calibrate import calibrate
    from repro_torch.configs import get_arch

    cfg = get_arch(CALIBRATE["arch"])
    batches = _calibration_batches(cfg, seed)
    CALIBRATE_OUT.mkdir(parents=True, exist_ok=True)
    out = {}
    for target in CALIBRATE["targets"]:
        name = str(target)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = calibrate(CALIBRATE["arch"], reduced=False, target_bpv=target,
                      seed=seed, kv_format="hif4", params=raw, batches=batches,
                      device=dev, out=str(CALIBRATE_OUT / f"{name}.json"),
                      report_out=str(CALIBRATE_OUT / f"{name}.report.json"),
                      log=lambda m: print(f"  {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t = s["timings"]
        print(f"  target {name}: {wall:.2f} s (probe {t['probe_s']:.2f} s, "
              f"HiGPTQ {t['higptq_s']:.2f} s, other scoring "
              f"{t['score_s']:.2f} s, search {t['search_s'] * 1e3:.2f} ms) on "
              f"{card_line()}")
        if target == CALIBRATE["targets"][0]:
            print(f"  {'site':18} {'hif4 (HiGPTQ)':>14} {'hif4_direct':>12} "
                  f"{'nvfp4':>10} {'mxfp4':>10}  in budget")
            for path, r in _site_rows(s).items():
                if r["errors"] is not None:
                    e = r["errors"]
                    print(f"  {path:18} {e['hif4']:14.6f} {e['hif4_direct']:12.6f} "
                          f"{e['nvfp4']:10.6f} {e['mxfp4']:10.6f}  {r['in_budget']}")
        print(f"  achieved {s['achieved_bpv']} B/value ({s['total_bytes']} B, "
              f"{s['n_packed']} of {s['n_sites']} sites packed: "
              f"{sorted(p for p, f in s['assignment'].items() if f == 'hif4')}); "
              f"error {s['total_error']:.1f}")
        for preset, b in s["baselines"].items():
            print(f"  baseline {preset:20} {b['achieved_bpv']:.6f} B/value "
                  f"{b['total_bytes']} B, error {b['total_error']:.1f}")
        check(s["feasible"], f"target {name}: infeasible")
        curve = s["report"]["pareto_curve"]
        check(len(curve) >= 2 and all(b["total_bytes"] < a["total_bytes"]
                                       for a, b in zip(curve, curve[1:])),
              f"target {name}: the curve's bytes do not fall strictly")
        _check_higptq_bound(f"full width {name}", s)
        out[target] = s
    s = out["sensitive-fallback"]
    fb = s["baselines"]["sensitive-fallback"]
    check(s["total_bytes"] <= fb["total_bytes"] and s["total_error"]
          <= fb["total_error"] + 1e-6, f"at the fallback's bytes the search "
          f"({s['total_bytes']} B, error {s['total_error']}) does not dominate "
          f"the preset ({fb['total_bytes']} B, error {fb['total_error']})")
    check(0 < s["n_packed"] < s["n_sites"], "the fallback budget's plan is not "
          "mixed")
    check(out[0.7]["achieved_bpv"] <= 0.7, "0.7: over budget")
    return out


def _budget_bytes(sparams, paths) -> int:
    """Resident bytes of the served tree's leaves at ``paths`` (PackedW:
    codes + meta; dense: the tensor)."""
    from repro_torch.core.qlinear import PackedW

    total = 0
    for path in paths:
        node = sparams
        for part in path.split("."):
            node = node[part]
        ts = (node.codes, node.meta) if isinstance(node, PackedW) else (node,)
        total += sum(t.numel() * t.element_size() for t in ts)
    return total


def calibrate_serve(dev, seed, raw, summary) -> None:
    """(c) the fallback budget's emitted policy file served at full width:
    get_policy(file, impl="packed") with its HiF4 KV, batch 8, prompt 480;
    exact launches from the assignment (the bf16 sites take torch.matmul),
    the served in-budget bytes equal to the report's, the first steps
    against the plain versions."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prefill_batch
    from repro_torch.models import lm
    from repro_torch.models.common import ModelCtx
    from repro_torch.runtime.serve_loop import (
        ServeConfig, prepare_params_for_serving, serve)

    cfg = get_arch(CALIBRATE["arch"])
    pol = get_policy(summary["policy_path"], impl="packed")
    check(pol.kv.kv_format == "hif4", f"policy file KV {pol.kv.kv_format}")
    ctx = ModelCtx(plan=lm.quant_plan(cfg, pol))
    packed = sorted(p for p, f in summary["assignment"].items() if f == "hif4")
    check(sorted(ctx.plan.packed_paths) == packed, f"the file's plan packs "
          f"{sorted(ctx.plan.packed_paths)}, the search {packed}")
    sparams = prepare_params_for_serving(raw, cfg, ctx.plan, device=dev)
    served = _budget_bytes(sparams, summary["assignment"])
    print(f"  {summary['policy_path']}: packs {packed}; served in-budget bytes "
          f"{served} (report {summary['report']['search']['total_bytes']})")
    check(served == summary["report"]["search"]["total_bytes"] ==
          summary["total_bytes"], "served bytes != the report's total_bytes")
    m, prompt, new = FAMILY_BATCH, FAMILY_PROMPT, CALIBRATE["new_tokens"]
    batch = prefill_batch(cfg, m, prompt, seed + 1, dev)
    serve(cfg, sparams, {k: v[:, :64] for k, v in batch.items()}, ctx,
          ServeConfig(max_new_tokens=2), device=dev)          # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    stats: dict = {}
    toks = serve(cfg, sparams, batch, ctx, ServeConfig(max_new_tokens=new),
                 device=dev, stats=stats)
    torch.cuda.synchronize()
    launches, per_shape = dict(build.LAUNCHES), dict(build.SHAPE_LAUNCHES)
    steps = stats["decode_steps"]
    print(f"  prefill {stats['prefill_s'] * 1e3:.1f} ms for {m} x {prompt} "
          f"tokens; decode {stats['decode_s'] * 1e3 / steps:.2f} ms/step "
          f"({m * steps / stats['decode_s']:.1f} tokens/s over {steps} steps); "
          f"{card_line()}")
    want, want_shapes = expected_launches(cfg, _packed_shapes(sparams), steps,
                                          m, m * prompt)
    print(f"  launches: {launches} (expected from {len(packed)} packed sites "
          f"x {cfg.n_layers} layers: {want})")
    check(launches == want, f"launch counts {launches} != {want}")
    check(per_shape == want_shapes, f"launches per shape {per_shape} != "
          f"{want_shapes}")
    check(tuple(toks.shape) == (m, new), f"tokens shape {tuple(toks.shape)}")
    print(f"  request 0: {toks[0].tolist()}")
    _check_tokens_vary("calibrated", toks.cpu())
    check_against_plain("calibrated", cfg, sparams,
                        {k: v.to(dev) for k, v in batch.items()}, ctx, new, toks)


def phase_calibrate(dev, seed):
    """Calibration on the card: (a) reduced card vs CPU, (b) full width and
    depth at two targets, (c) the fallback budget's policy file served on
    the ported kernels."""
    import torch
    from repro_torch.configs import get_arch

    t0 = time.perf_counter()

    def part(label):
        print(f"  -- {label} (at {time.perf_counter() - t0:.1f} s)")

    part("(a) reduced, card vs CPU")
    calibrate_card_vs_cpu(dev, seed)
    part("(b) full width and depth")
    cfg = get_arch(CALIBRATE["arch"])
    raw = family_weights(cfg, seed, dev)
    summaries = calibrate_full(dev, seed, raw)
    torch.cuda.empty_cache()
    part("(c) the searched policy served")
    calibrate_serve(dev, seed, raw, summaries["sensitive-fallback"])
    del raw
    torch.cuda.empty_cache()
    part("done")


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

# the full run (b) and the 1-layer full-width cut of (c)-(e) (2 layers until
# phase examples came: a cut for the script's time); (d) kills the
# cut's run after step KILL_AT + 1 (its checkpoint at KILL_AT) and resumes;
# (e) trains the cut TRAINED_STEPS steps, about 60 s on the card (353 and
# 372 steps took 56.2 and 62.0 s; NVIDIA H100 80GB HBM3, 700 W), a fixed
# count so the trained weights are the same in every run
TRAIN = {"arch": "qwen1.5-0.5b", "steps": 16, "batch": 8, "seq": 128,
         "cut_layers": 1, "cut_batch": 4, "resume_steps": 4, "kill_at": 2,
         "trained_steps": 120, "prompt": 64}
TRAIN_OUT = ROOT / ".train"
# (a) (B, S, H, D, chunk): the train shape and S 512 with 256-chunks
TRAIN_FLASH = ((8, 128, 16, 64, 128), (8, 512, 16, 64, 256))
# (c) card vs cpu, one step of the cut: the loss, and by the relative norm
# of each leaf's difference its gradient, its first moment and its change
# p_new - p_old. On AdamW's first step the change is about lr x sign(g),
# so it differs where the gradient's sign does: a skipped update reads 1, a
# flipped or doubled one 1 or more. Measured on the 2-layer cut (NVIDIA
# H100 80GB HBM3, 700 W): loss 9.5e-5; gradients and first moments 0.027-0.041 (limit 2.4x the
# worst); changes 0.17-0.25, 0.57 for the key bias, whose exact gradient
# is 0 (limit 1.3x that)
TRAIN_CUT_TOL = {"loss_rtol": 1e-3, "grad_rel": 0.1, "m_rel": 0.1,
                 "dp_rel": 0.75}


def _naive_attention(q, k, v, causal):
    """Softmax attention in f32 over the whole sequence, GQA by view."""
    import torch

    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    qf = q.float().reshape(B, Sq, Hkv, H // Hkv, D) / (D ** 0.5)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float())
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, -1e30)
    o = torch.einsum("bgrqk,bkgd->bqgrd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def train_flash(dev):
    """(a) The flash autograd.Functions (scan_q's ``flash_mha`` and vec_q's
    ``flash_mha_vec``) against autograd of the naive attention on the card:
    the vec form's output, and both backwards; f32 operands within the
    reference test's atol 3e-5; bf16 operands (p and ds round to bf16 in the
    flash backwards, as in the reference) within 2^-7 of the largest value.
    The vec_q backward's peak memory above its operands, at these shapes and
    at a train_4k cut (B 2, S 4 096, the ModelCtx's chunks 512 / 1 024)
    beside scan_q's."""
    import torch
    from repro_torch.models.attention import (AttnChunking, flash_mha,
                                              flash_mha_vec)

    forms = {"flash": flash_mha, "vec_q flash": flash_mha_vec}
    for b, s, h, d, c in TRAIN_FLASH:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device=dev).manual_seed(s + causal)
                qkv = [torch.randn((b, s, h, d), generator=gen, device=dev)
                       .to(dtype).requires_grad_(True) for _ in range(3)]

                def grads(fn):
                    out = fn(*qkv)
                    loss = torch.sum(torch.sin(out.float()))
                    return (out.detach(),) + torch.autograd.grad(loss, qkv)

                want = grads(lambda q, k, v: _naive_attention(q, k, v, causal))
                top = max(float(y.float().abs().max()) for y in want[1:])
                tol = 3e-5 if dtype == torch.float32 else 2 ** -7 * top
                name = str(dtype).replace("torch.", "")
                for form, fn in forms.items():
                    got = grads(lambda q, k, v: fn(q, k, v, causal, 0,
                                                   AttnChunking(c, c)))
                    err = max(float((x.float() - y.float()).abs().max())
                              for x, y in zip(got[1:], want[1:]))
                    print(f"  {form} backward B={b} S={s} H={h} D={d} chunk "
                          f"{c} causal={causal} {name}: dq/dk/dv max |d| "
                          f"{err:.3g} (largest gradient {top:.3f}, limit "
                          f"{tol:.3g})")
                    check(err <= tol, f"the {form} backward differs from the "
                          f"naive attention's by {err} at S={s} {name}")
                    if form == "vec_q flash":
                        o_err = float((got[0].float() - want[0].float())
                                      .abs().max())
                        o_tol = (3e-5 if dtype == torch.float32 else
                                 2 ** -7 * float(want[0].float().abs().max()))
                        print(f"  vec_q flash forward: max |d| {o_err:.3g} "
                              f"(limit {o_tol:.3g})")
                        check(o_err <= o_tol, f"the vec_q flash forward "
                              f"differs from the naive attention's by {o_err}")
    # peak memory of each backward (forward included) above its operands
    for b, s, h, d, cq, ck in ((8, 128, 16, 64, 128, 128),
                               (2, 4096, 16, 64, 512, 1024)):
        gen = torch.Generator(device=dev).manual_seed(s)
        qkv = [torch.randn((b, s, h, d), generator=gen, device=dev)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3)]
        peaks, got = {}, {}
        for form, fn in forms.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*qkv, True, 0, AttnChunking(cq, ck))
            got[form] = torch.autograd.grad(torch.sum(torch.sin(out.float())),
                                            qkv)
            del out
            torch.cuda.synchronize()
            peaks[form] = torch.cuda.max_memory_allocated() - base
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got["vec_q flash"], got["flash"]))
        top = max(float(y.float().abs().max()) for y in got["flash"])
        print(f"  peak memory above the operands, causal bf16 B={b} S={s} "
              f"H={h} D={d} chunks {cq}/{ck}: vec_q backward "
              f"{peaks['vec_q flash'] / 2**20:.1f} MiB, scan_q "
              f"{peaks['flash'] / 2**20:.1f} MiB; vec_q vs scan_q gradients "
              f"max |d| {err:.3g} (limit {2 ** -7 * top:.3g}); {card_line()}")
        check(err <= 2 ** -7 * top, f"vec_q and scan_q gradients differ by "
              f"{err} at S={s}")
        del got, qkv
        torch.cuda.empty_cache()


class _Tee:
    """A stdout that writes to two streams."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def _launcher(argv) -> dict:
    """``python -m repro_torch`` + argv in-process: its losses and summary
    (median step ms, tokens/s, peak memory); no kernel may launch."""
    import io
    import re

    from repro_torch import __main__ as front_door
    from repro_torch.kernels import build

    print(f"  python -m repro_torch {' '.join(argv)}")
    build.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = front_door.main(argv)
    check(rc == 0, f"the train launcher exited {rc}")
    launched = {k: n for k, n in build.LAUNCHES.items() if n}
    print(f"  kernel launches during training: {launched or 'none'}")
    check(not launched, f"training launched kernels {launched} (impl qdq)")
    text = buf.getvalue()
    losses = [float(x) for x in re.findall(r"step\s+\d+ loss (\S+) \(", text)]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    summary = re.search(r"median step (\S+) ms, (\S+) tokens/s, peak memory "
                        r"(.+)$", text, re.M)
    check(summary is not None, "no step-time line")
    return {"losses": losses, "median_ms": float(summary.group(1)),
            "tokens_s": float(summary.group(2)), "peak": summary.group(3)}


def train_full(dev, seed):
    """(b) ``python -m repro_torch train`` in-process at full width and
    depth: finite, falling losses and no kernel launch (impl qdq)."""
    import torch

    t = TRAIN
    r = _launcher(["train", "--arch", t["arch"], "--steps", str(t["steps"]),
                   "--global-batch", str(t["batch"]), "--seq-len",
                   str(t["seq"]), "--seed", str(seed), "--log-every", "1"])
    losses = r["losses"]
    check(len(losses) == t["steps"], f"{len(losses)} loss lines")
    first, last = sum(losses[:4]) / 4, sum(losses[-4:]) / 4
    print(f"  losses {' '.join(f'{x:.4f}' for x in losses)}; mean of the "
          f"first 4 {first:.4f}, of the last 4 {last:.4f}")
    check(last < first, "the loss did not fall over the run")
    print(f"  full width and depth: median step {r['median_ms']} ms, "
          f"{r['tokens_s']} tokens/s, peak memory {r['peak']} "
          f"(torch.cuda.max_memory_allocated); {card_line()}")
    torch.cuda.empty_cache()


def _cut(seed, dev):
    """The full-width cut (``TRAIN["cut_layers"]``) and its weights drawn
    on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch(TRAIN["arch"]),
                              n_layers=TRAIN["cut_layers"])
    return cfg, lm.init_params(cfg, seed + 6, device=dev, draw_on_device=True)


def _train_ctx(fmt="hif4"):
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.models.common import ModelCtx

    s = TRAIN["seq"]
    return ModelCtx(quant=QuantConfig(fmt=fmt), remat=True,
                    attn_q_chunk=min(512, s), attn_k_chunk=min(1024, s))


def _rel_by_leaf(names, got, want, dev) -> dict:
    """{leaf name: |got - want| / |want|} (L2 norms in float64 on ``dev``)."""
    import torch

    out = {}
    for n, a, b in zip(names, got, want):
        a, b = (x.to(dev, torch.float64) for x in (a, b))
        out[n] = float(torch.linalg.norm(a - b)
                       / torch.clamp_min(torch.linalg.norm(b), 1e-30))
    return out


def train_card_vs_cpu(dev, seed, cfg, raw, fmt="hif4", batch_rows=None,
                      bounded=True, batch=None, tol=None, label=None):
    """(c) One step of the cut from the same weights and batch (default the
    synthetic tokens; ``batch`` a family's inputs on the host) on the card
    and on the CPU: the loss, and by the relative norm of each leaf's
    difference its gradient, its AdamW first moment and its change
    p_new - p_old (bounded by ``tol``, default TRAIN_CUT_TOL, or printed
    only). Returns the worst reading of each."""
    import torch
    from repro_torch.checkpoint.checkpoint import (tree_flatten, tree_leaves,
                                                   tree_unflatten)
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import _grads
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    if batch is None:
        batch = {"tokens": SyntheticLMDataset(
            cfg.vocab, TRAIN["seq"], batch_rows or TRAIN["cut_batch"],
            seed=seed).batch_at(0)["tokens"]}
    label = label or fmt
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    old = [x.detach().float().cpu() for x in tree_flatten(raw)]
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        p = _map_tensors(raw, lambda x: x.detach().to(d, copy=True))
        leaves = tree_flatten(p)
        for x in leaves:
            x.requires_grad_(True)
        loss = lm.train_loss(p, {k: v.to(d) for k, v in batch.items()}, cfg,
                             _train_ctx(fmt))
        grads = _grads(loss, leaves)
        state = adamw_init(p)
        adamw_update(p, tree_unflatten(p, grads), state, opt)
        out[name] = (float(loss.detach()), [g.float().cpu() for g in grads],
                     [x.cpu() for x in tree_flatten(state["m"])],
                     [x.detach().float().cpu() - o
                      for x, o in zip(leaves, old)])
        print(f"  {label}, {name}: loss {float(loss.detach()):.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    (lk, *card), (lc, *cpu) = out["card"], out["cpu"]
    names = [".".join(k) for k, _, _ in tree_leaves(raw)]
    tol = tol or TRAIN_CUT_TOL
    worst = {"loss_rtol": ("loss", abs(lk - lc) / abs(lc))}
    print(f"  {label}, card vs cpu: loss rel {worst['loss_rtol'][1]:.3g} "
          f"(limit {tol['loss_rtol']})" + ("" if bounded else "; not bounded"))
    for what, a, b in zip(("grad_rel", "m_rel", "dp_rel"), card, cpu):
        rel = _rel_by_leaf(names, a, b, dev)
        w = max(rel, key=rel.get)
        worst[what] = (w, rel[w])
        print(f"  {label}, card vs cpu, {what[:-4]} by leaf: worst {w} "
              f"{rel[w]:.3g} (limit {tol[what]}); "
              + ", ".join(f"{n} {r:.2g}" for n, r in rel.items()))
    if bounded:
        for what, (w, r) in worst.items():
            check(r <= tol[what], f"{label}: {what[:-4]} of {w} card vs cpu: "
                  f"{r} beyond {tol[what]}")
    return worst


class _Killed(Exception):
    pass


def train_kill_and_resume(dev, seed, cfg, raw, label="") -> None:
    """(d) The cut's run killed after step KILL_AT + 1 (checkpoint at
    KILL_AT), resumed from its directory: the resumed steps' losses and the
    final params equal the uninterrupted run's bitwise. Beside it, the
    deterministic-algorithms warnings the uninterrupted run raised (an op
    with no deterministic CUDA implementation)."""
    import shutil
    import warnings

    import torch
    from repro_torch.checkpoint import latest_step
    from repro_torch.checkpoint.checkpoint import tree_flatten
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainLoopConfig, train

    t = TRAIN
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=t["resume_steps"])
    ckpt = TRAIN_OUT / ("resume" + (f"-{label}" if label else ""))
    shutil.rmtree(ckpt, ignore_errors=True)

    def run(steps, directory=None, on_step=None, fresh=True):
        loop = TrainLoopConfig(steps=steps, global_batch=t["batch"],
                               seq_len=t["seq"], checkpoint_dir=directory,
                               checkpoint_every=t["kill_at"], seed=seed)
        params = (_map_tensors(raw, lambda x: x.detach().clone())
                  if fresh else None)
        p, _, hist = train(cfg, _train_ctx(), loop, opt, on_step, device=dev,
                           params=params)
        return hist, [_bits(x.detach()) for x in tree_flatten(p)]

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        full, p_full = run(t["resume_steps"])
    nondet = sorted({str(w.message).splitlines()[0][:160] for w in caught
                     if "deterministic" in str(w.message)})

    def kill(step, _):
        if step == t["kill_at"]:
            raise _Killed

    try:
        run(t["resume_steps"], str(ckpt), kill)
        check(False, "the killed run was not killed")
    except _Killed:
        pass
    deadline = time.perf_counter() + 300          # the async save in flight
    while latest_step(str(ckpt)) != t["kill_at"] and time.perf_counter() < deadline:
        time.sleep(0.5)
    check(latest_step(str(ckpt)) == t["kill_at"], "no checkpoint at the kill")
    resumed, p_res = run(t["resume_steps"], str(ckpt), fresh=False)
    want = full["loss"][t["kill_at"]:]
    same = equal(p_res, p_full)
    print(f"  {label or cfg.name}: uninterrupted losses {full['loss']}; killed "
          f"after step {t['kill_at'] + 1} (checkpoint at {t['kill_at']}), "
          f"resumed {resumed['loss']}: losses equal {resumed['loss'] == want}, "
          f"final params bitwise {same}; deterministic-algorithms warnings: "
          f"{nondet or 'none'}")
    check(resumed["loss"] == want and same, f"{label or cfg.name}: the resumed "
          f"run differs from the uninterrupted one")
    shutil.rmtree(ckpt, ignore_errors=True)


def train_trained_model(dev, seed, cfg, raw) -> None:
    """(e) The share of prefill logits outside rtol=0.05, atol=0.1 card vs
    cpu (printed, not bounded) of the cut untrained and trained
    TRAINED_STEPS steps, on the same synthetic prompts, so the two differ by
    the training alone (phase e2e serves and checks the tokens and the
    bitwise card-plain run on its own weights)."""
    import torch
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.runtime.train_loop import TrainLoopConfig, train

    t = TRAIN
    prompts = SyntheticLMDataset(cfg.vocab, t["prompt"], 2, seed=seed + 2
                                 ).batch_at(0)["tokens"]
    t0 = time.perf_counter()
    untrained_cpu = _map_tensors(raw, lambda x: x.detach().cpu())
    print("  the untrained cut, prefill logits on the synthetic prompts:")
    untrained = e2e_prefill_shares(dev, cfg, untrained_cpu, prompts)
    del untrained_cpu
    print(f"  the untrained cut compared in {time.perf_counter() - t0:.1f} s")
    steps = t["trained_steps"]
    loop = TrainLoopConfig(steps=steps, global_batch=t["batch"], seq_len=t["seq"],
                           seed=seed + 1)
    t0 = time.perf_counter()
    params, _, hist = train(cfg, _train_ctx(), loop, device=dev,
                            params=_map_tensors(raw, lambda x: x.detach().clone()))
    losses = hist["loss"]
    marks = sorted({0, *range(0, steps, max(1, steps // 10)), steps - 1})
    print(f"  trained the cut {steps} steps in {time.perf_counter() - t0:.1f} s: "
          f"loss " + ", ".join(f"step {i} {losses[i]:.4f}" for i in marks))
    check(all(math.isfinite(x) for x in losses), "a non-finite loss")
    check(sum(losses[-10:]) < sum(losses[:10]), "the trained loss did not fall")
    trained = _map_tensors(params, lambda x: x.detach().cpu())
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print("  the trained cut, prefill logits on the synthetic prompts:")
    shares = e2e_prefill_shares(dev, cfg, trained, prompts)
    print(f"  the trained cut compared in {time.perf_counter() - t0:.1f} s")
    for policy, share in shares.items():
        init = E2E_INIT_SHARES.get(policy)
        print(f"  {policy}: {100 * share:.3f}% of prefill logits outside "
              f"rtol=0.05, atol=0.1 card vs cpu on the trained cut, "
              f"{100 * untrained[policy]:.3f}% on the same cut untrained "
              f"(the same prompts); phase e2e's init-scale weights on its "
              f"own prompts: "
              + (f"{100 * init:.3f}%" if init is not None
                 else "not run in this call"))


# (f) the five non-dense families: the card-vs-CPU step on a full-width cut
# of (arch, layers): granite, mamba2 and zamba2 1 (zamba2's Mamba layer and
# one call of its shared block after it), whisper 2 encoder and 2 decoder
# layers (granite's, mamba2's and zamba2's CPU steps took 19.3, 9.4 and
# 22.5 s at 2 layers, NVIDIA H100 80GB HBM3, 700 W: cut to 1 for the
# script's time);
# tokens of the synthetic stream, whisper's seeded f32 frames; the launcher
# at (arch, layers, steps), granite 6 -> 3, mamba2 16 -> 8 and zamba2 12 ->
# 6 layers for time; kill and resume on the same cuts; llava-next-34b
# trained on its 2-layer full-width cut for time and memory, its card-vs-CPU
# step at the reduced config (the full-width cut's step is ~6 TFLOP, minutes
# on the CPU)
TRAIN_FAMILIES = {
    "cut": (("granite-moe-1b-a400m", 1), ("mamba2-1.3b", 1), ("zamba2-2.7b", 1),
            ("whisper-tiny", 2)),
    "rows": 1, "frames": 256,
    "launcher": (("granite-moe-1b-a400m", 3, 4), ("mamba2-1.3b", 8, 4),
                 ("zamba2-2.7b", 6, 4)),
    "resume": ("granite-moe-1b-a400m", "mamba2-1.3b", "zamba2-2.7b"),
    "vlm": "llava-next-34b", "vlm_steps": 4}
# (f)'s card-vs-CPU limits where TRAIN_CUT_TOL does not hold: zamba2, whose
# HiF4 fake quantization amplifies the card/CPU float differences. Measured
# (NVIDIA H100 80GB HBM3, 700 W; one row): the 2-layer cut's loss 7.0e-4,
# gradients and first moments 0.10-0.13 by leaf, changes 0.30-0.41 (the
# script now runs the 1-layer cut); on a 6-layer cut 0.24-0.40 and 0.54-0.67, the same step unquantized 0.035 and
# 0.22. Gradient limits 1.5x the 2-layer reading, the change's as
# TRAIN_CUT_TOL (the other families hold TRAIN_CUT_TOL: gradients <= 0.07,
# changes <= 0.31)
TRAIN_FAMILY_TOL = {"zamba2-2.7b": {"loss_rtol": 1e-3, "grad_rel": 0.2,
                                    "m_rel": 0.2, "dp_rel": 0.75}}


def _family_cut(arch, layers, seed, dev):
    """``arch`` at full width on its first ``layers`` layers (and as many
    encoder layers; the hybrid's shared block called once, after them),
    weights drawn on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    cfg = get_arch(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers, **(
        {"enc_layers": layers} if cfg.enc_layers else {}), **(
        {"hybrid_attn_every": layers} if cfg.hybrid_attn_every else {}))
    return cfg, lm.init_params(cfg, seed + 6, device=dev, draw_on_device=True)


def _family_batch(cfg, rows, seed) -> dict:
    """One training batch on the host, as tests/test_torch_train_families.py
    makes it: the synthetic stream's tokens; with seeded f32 frames (audio),
    or seeded f32 embeds and the tokens as labels (vlm)."""
    import torch
    from repro_torch.data import SyntheticLMDataset

    toks = SyntheticLMDataset(cfg.vocab, TRAIN["seq"], rows,
                              seed=seed).batch_at(0)["tokens"]
    gen = torch.Generator().manual_seed(seed + 7)
    if cfg.family == "audio":
        return {"frames": torch.randn(rows, TRAIN_FAMILIES["frames"],
                                      cfg.d_model, generator=gen),
                "tokens": toks}
    if cfg.embeds_input:
        return {"embeds": 0.02 * torch.randn(rows, TRAIN["seq"], cfg.d_model,
                                             generator=gen), "labels": toks}
    return {"tokens": toks}


def train_vlm(dev, seed) -> None:
    """llava-next-34b: its 2-layer full-width cut trained a few steps on the
    card (embeds and labels; median step ms, tokens/s, peak memory), and its
    card-vs-CPU step at the reduced config."""
    import statistics

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    f = TRAIN_FAMILIES
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params = _family_cut(f["vlm"], 2, seed, dev)
    step_fn = make_train_step(cfg, _train_ctx(), AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=f["vlm_steps"]))
    opt = adamw_init(params)
    losses, times = [], []
    for i in range(f["vlm_steps"]):
        batch = {k: v.to(dev) for k, v in _family_batch(
            cfg, TRAIN["batch"], seed + i).items()}
        t0 = time.perf_counter()
        params, opt, stats = step_fn(params, opt, batch)
        losses.append(stats["loss"].item())
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    med = statistics.median(times)
    print(f"  {cfg.name} 2 of 60 layers, full width, batch {TRAIN['batch']} x "
          f"{TRAIN['seq']} embeds: losses {[round(x, 4) for x in losses]}; "
          f"median step {med * 1e3:.2f} ms, "
          f"{TRAIN['batch'] * TRAIN['seq'] / med:.0f} tokens/s, peak memory "
          f"{peak:.3f} GiB; {card_line()}")
    check(all(math.isfinite(x) for x in losses), f"{cfg.name}: losses {losses}")
    del params, opt, step_fn
    torch.cuda.empty_cache()
    red = get_arch(f["vlm"]).reduced()
    raw = lm.init_params(red, seed + 6, device=dev, draw_on_device=True)
    train_card_vs_cpu(dev, seed, red, raw, batch=_family_batch(
        red, f["rows"], seed), label=f"{red.name} (reduced)")


def train_families(dev, seed) -> None:
    """(f) The five non-dense families on the card (impl qdq, no kernel):
    card vs CPU one step on each full-width cut, the launcher at depth,
    kill and resume, and llava-next-34b (:func:`train_vlm`)."""
    import torch

    f = TRAIN_FAMILIES
    for arch, layers in f["cut"]:
        cfg, raw = _family_cut(arch, layers, seed, dev)
        train_card_vs_cpu(dev, seed, cfg, raw, batch=_family_batch(
            cfg, f["rows"], seed), tol=TRAIN_FAMILY_TOL.get(arch),
            label=f"{arch} ({layers} layers)")
        if arch in f["resume"]:
            train_kill_and_resume(dev, seed, cfg, raw, label=arch)
        del raw
        torch.cuda.empty_cache()
    for arch, layers, steps in f["launcher"]:
        r = _launcher(["train", "--arch", arch, "--layers", str(layers),
                       "--steps", str(steps), "--global-batch",
                       str(TRAIN["batch"]), "--seq-len", str(TRAIN["seq"]),
                       "--seed", str(seed), "--log-every", "1"])
        check(len(r["losses"]) == steps, f"{arch}: {len(r['losses'])} losses")
        print(f"  {arch} {layers} layers, full width: median step "
              f"{r['median_ms']} ms, {r['tokens_s']} tokens/s, peak memory "
              f"{r['peak']}; {card_line()}")
        torch.cuda.empty_cache()
    train_vlm(dev, seed)


def phase_train(dev, seed):
    """Training on the card: (a) the flash backward, (b) the launcher at
    full width and depth, (c) card vs cpu on the 1-layer cut, (d) kill and
    resume, (e) the cut before and after training through phase e2e's
    comparison, (f) the five non-dense families."""
    import torch

    t0 = time.perf_counter()

    def part(label):
        print(f"  -- {label} (at {time.perf_counter() - t0:.1f} s)")

    part("(a) the flash attention backward")
    train_flash(dev)
    part("(b) python -m repro_torch train, full width and depth")
    train_full(dev, seed)
    cfg, raw = _cut(seed, dev)
    part("(c) the 1-layer cut, one step, card vs cpu")
    train_card_vs_cpu(dev, seed, cfg, raw)
    # what the HiF4 fake quantization adds to the card/CPU difference: the
    # same step unquantized, on one row of the batch (printed only)
    train_card_vs_cpu(dev, seed, cfg, raw, fmt="none", batch_rows=1,
                      bounded=False)
    part("(d) kill and resume")
    train_kill_and_resume(dev, seed, cfg, raw)
    part("(e) the cut untrained and trained, card vs cpu")
    train_trained_model(dev, seed, cfg, raw)
    del raw
    torch.cuda.empty_cache()
    part("(f) the non-dense families")
    train_families(dev, seed)
    part("done")


# ---------------------------------------------------------------------------
# phase 14: the dry run held against the card
# ---------------------------------------------------------------------------

# (arch, shape, batch cut): the dry run at the cut batch against real runs of
# the same steps at full width and depth; None keeps the shape's batch
# (arch, shape, batch cut or None, layers or None for all): train_4k on 6
# and prefill_32k on 4 of qwen1.5-0.5b's 24 layers, for the script's time
# (at full depth they took 16.9 and 83.4 s; NVIDIA H100 80GB HBM3, 700 W)
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k", 2, 6),
                ("qwen1.5-0.5b", "prefill_32k", 1, 4),
                ("qwen1.5-0.5b", "decode_32k", 8, None),
                ("zamba2-2.7b", "long_500k", None, None),
                ("mamba2-1.3b", "long_500k", None, None))
# the dry run's peak against the card's max_memory_allocated, relative
DRYRUN_PEAK_REL = 0.10
# timed runs of a cell's step after the counted one (the least is printed):
# one of a train or prefill step (seconds each), three of a decode step
DRYRUN_TIMED = {"train": 1, "prefill": 1, "decode": 3}
# the serving route at the assignment's shapes: a 32 768-token prefill at
# batch 1 (kernels 1 and 2 at M = 32 768), then one decode step from that
# HiF4 cache (kernel 2's decode form, kernel 3 over 32 768 tokens), on 6
# of the 24 layers for the script's time (all 24 until the scenario phase
# came; the kernels are held on layer 0's operands)
DRYRUN_SERVE = {"arch": "qwen1.5-0.5b", "prompt": 32768, "new": 2,
                "layers": 6}
# kernel 3 over 32 769 near-uniformly weighted tokens gives outputs of about
# |v| / sqrt(S), not far above the elementwise atol of 1e-3: it is also held
# by ||y - ref|| / ||ref||, far below the ~8% a tile dropped or counted
# twice would make
DRYRUN_ATTN_REL = 1e-3


def _tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree of tensors."""
    import torch

    seen: dict = {}

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, torch.Tensor):
            st = node.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()

    walk(tree)
    return sum(seen.values())


def _real_inputs(specs, shape, vocab, gen, dev):
    """The step's inputs after the params on the card: token ids drawn from
    ``gen``, everything else zeros; a decode cache's position at the last
    slot (the cache full)."""
    import torch
    from repro_torch.models.params import PSpec, map_specs

    def leaf(p: PSpec):
        if p.dtype == torch.int32 and p.shape and p.init == "zeros" \
                and shape.kind != "decode":
            return torch.randint(0, vocab, p.shape, generator=gen,
                                 dtype=torch.int32).to(dev)
        return torch.zeros(p.shape, dtype=p.dtype, device=dev)

    out = [leaf(s) if isinstance(s, PSpec) else map_specs(leaf, s)
           for s in specs]
    if shape.kind == "decode":
        out[0]["pos"].fill_(shape.seq_len - 1)
    return out


def dryrun_cell(dev, seed, arch, shape_name, batch, layers) -> dict:
    """One cell: the dry run (on meta, here) at the cut batch and depth,
    then the same step on the card: residency exact, the peak within
    DRYRUN_PEAK_REL, the matmul FLOPs equal to a FlopCounterMode count of
    the card run, the step time beside max(t_compute, t_memory)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init

    cfg = dryrun.cell_config(arch, layers)
    t0 = time.perf_counter()
    rec, _, _ = dryrun.lower_cell(arch, shape_name, batch=batch, layers=layers)
    dry_s = time.perf_counter() - t0
    shape = dataclasses.replace(get_shape(shape_name),
                                global_batch=rec["global_batch"])
    specs = dryrun.cell_specs(cfg, shape)
    gen = torch.Generator().manual_seed(seed + 14)
    params = lm.init_params(cfg, seed, device=dev, draw_on_device=True)
    if shape.kind == "train":
        args = [params, adamw_init(params)] + _real_inputs(
            specs[2:], shape, cfg.vocab, gen, dev)
        names = ("params", "opt_state")
    else:
        args = [params] + _real_inputs(specs[1:], shape, cfg.vocab, gen, dev)
        names = ("params", "kv_cache") if shape.kind == "decode" else ("params",)
    resident = rec["resident_bytes_per_device"]
    held = {n: _tree_bytes(a) for n, a in zip(names, args)}
    check(held == resident, f"{arch} {shape_name}: the card holds {held} B, "
          f"the dry run says {resident}")
    check(sum(_tree_bytes(a) for a in args) == rec["memory"]["argument_bytes"],
          f"{arch} {shape_name}: argument bytes differ")
    step = dryrun.make_cell_step(cfg, shape, microbatches=rec["microbatches"])
    grad = (contextlib.nullcontext if shape.kind == "train" else torch.no_grad)
    build.reset_launches()
    with FlopCounterMode(display=False) as fc, grad():
        out = step(*args)                 # also the warm-up
    torch.cuda.synchronize()
    del out
    flops = fc.get_total_flops()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DRYRUN_TIMED[shape.kind]):
        t0 = time.perf_counter()
        with grad():
            out = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
    step_ms = min(times)
    peak = torch.cuda.max_memory_allocated()
    check(not any(build.LAUNCHES.values()), f"{arch} {shape_name}: a kernel "
          f"launched in a plain (impl qdq) step: {build.LAUNCHES}")
    mem, roof = rec["memory"], rec["roofline"]
    est = mem["peak_bytes_est"]
    bound_ms = max(roof["t_compute_s"], roof["t_memory_s"]) * 1e3
    cut = ("" if batch is None else
           f" (cut from {get_shape(shape_name).global_batch})")
    if layers is not None:
        cut += f", {layers} of {get_arch(arch).n_layers} layers"
    print(f"  {arch} {shape_name} batch {shape.global_batch}{cut}: dry run "
          f"{dry_s:.1f} s on meta; residency {held} B exact; peak est "
          f"{est / 2**30:.3f} GiB vs card {peak / 2**30:.3f} GiB (ratio "
          f"{est / peak:.4f}; in the step est "
          f"{(est - mem['argument_bytes']) / 2**30:.3f} vs card "
          f"{(peak - base) / 2**30:.3f} GiB); matmul FLOPs dry "
          f"{roof['matmul_flops_per_device']:.0f} card {flops}; step "
          f"{step_ms:.2f} ms (least of {[round(t, 2) for t in times]}) vs max(t_compute {roof['t_compute_s'] * 1e3:.3f}, "
          f"t_memory {roof['t_memory_s'] * 1e3:.3f}) = {bound_ms:.3f} ms: "
          f"ratio {step_ms / bound_ms:.2f}; {card_line()}")
    check(abs(est / peak - 1) <= DRYRUN_PEAK_REL,
          f"{arch} {shape_name}: peak est {est} B vs the card's {peak} B, "
          f"beyond {DRYRUN_PEAK_REL:.0%}")
    check(flops == roof["matmul_flops_per_device"],
          f"{arch} {shape_name}: matmul FLOPs dry "
          f"{roof['matmul_flops_per_device']} != card {flops}")
    del args, params, step
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "bound_ms": bound_ms, "peak": peak, "est": est}


@contextlib.contextmanager
def first_operands():
    """Record the operands of the first engine call of kernels 1, 2 and 3 at
    each shape (layer 0's): {(kernel, shape): args}."""
    from repro_torch.core import engine

    seen: dict = {}
    saved = (engine.hif4_quantize, engine.fused_packed_matmul,
             engine.fused_decode_attention)
    quant, packed, attn = saved

    def rec_quant(x):
        seen.setdefault(("hif4_quantize", tuple(x.shape)), (x,))
        return quant(x)

    def rec_packed(ai, asc, codes, meta, dt):
        key = ("fused_packed_matmul", (tuple(ai.shape), tuple(codes.shape)))
        seen.setdefault(key, (ai, asc, codes, meta, dt))
        return packed(ai, asc, codes, meta, dt)

    def rec_attn(q, k, v, length, **kw):
        seen.setdefault(("fused_decode_attention", tuple(q.shape)),
                        (q, k, v, length, kw))
        return attn(q, k, v, length, **kw)

    engine.hif4_quantize, engine.fused_packed_matmul = rec_quant, rec_packed
    engine.fused_decode_attention = rec_attn
    try:
        yield seen
    finally:
        (engine.hif4_quantize, engine.fused_packed_matmul,
         engine.fused_decode_attention) = saved


def dryrun_serve(dev, seed, records) -> None:
    """The serving route at the assignment's shapes (paper-iv, impl packed,
    HiF4 KV): a 32 768-token prefill at batch 1 and one decode step from
    its cache; exact launches; greedy tokens and prefill logits against the
    plain versions' run; kernels 1 and 2 bitwise and kernel 3 within rtol
    2^-7, atol 1e-3 and a relative norm of DRYRUN_ATTN_REL of their plain
    versions on layer 0's operands, timed."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import kvcache
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_attention import (
        fused_decode_attention, fused_decode_attention_plain)
    from repro_torch.kernels.fused_matmul import (
        fused_packed_matmul, fused_packed_matmul_plain)
    from repro_torch.kernels.hif4_quant import absorbed_activation, hif4_quantize
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import prepare_params_for_serving

    arch, prompt, new = (DRYRUN_SERVE[k] for k in ("arch", "prompt", "new"))
    cfg = dataclasses.replace(get_arch(arch), n_layers=DRYRUN_SERVE["layers"])
    ctx = serving_setup(cfg)
    raw = lm.init_params(cfg, seed, device=dev, draw_on_device=True)
    sparams = prepare_params_for_serving(raw, cfg, ctx.plan, device=dev)
    del raw
    gen = torch.Generator().manual_seed(seed + 15)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, prompt),
                                     generator=gen).to(dev)}
    build.reset_launches()
    t0 = time.perf_counter()
    with first_operands() as ops, attention_capacities() as caps:
        toks_k, lg_k = greedy_steps(cfg, sparams, batch, ctx, new, new)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, per_shape = dict(build.LAUNCHES), dict(build.SHAPE_LAUNCHES)
    want, want_shapes = expected_launches(cfg, _packed_shapes(sparams), new - 1,
                                          1, prompt)
    print(f"  {arch} prefill {prompt} tokens + {new - 1} decode step (paper-iv, "
          f"packed, HiF4 KV) in {serve_s:.1f} s; launches {launches}; "
          f"kernel 3 per capacity {caps}")
    check(launches == want, f"serve at {prompt}: launches {launches} != {want}")
    check(per_shape == want_shapes, f"serve at {prompt}: launches per shape "
          f"{per_shape} != {want_shapes}")
    with plain_versions():
        toks_p, lg_p = greedy_steps(cfg, sparams, batch, ctx, new, new)
    same = torch.equal(lg_k[0].view(torch.int32), lg_p[0].view(torch.int32))
    print(f"  kernels vs plain versions: prefill logits bitwise {same}; greedy "
          f"tokens {toks_k.tolist()} vs {toks_p.tolist()}")
    check(same, f"serve at {prompt}: prefill logits differ from the plain run")
    check(torch.equal(toks_k, toks_p), f"serve at {prompt}: greedy tokens "
          f"{toks_k.tolist()} != the plain versions' {toks_p.tolist()}")
    for key, args in sorted(ops.items(), key=lambda kv: str(kv[0])):
        kernel, shp = key
        if kernel == "hif4_quantize":
            (x,) = args
            m, k = x.shape
            ki, ks = hif4_quantize(x)
            pi, ps = absorbed_activation(x)
            err = 0.0
            ok = torch.equal(ki, pi) and torch.equal(ks.view(torch.int32),
                                                     ps.view(torch.int32))
            t = timed(hif4_quantize, [(x,)], iters=20)
            plain_ms = cuda_ms(absorbed_activation, [(x,)], iters=3, warmup=1)
            bound_ms, bound_by, library_ms = _quantize_bound_ms(m, k), "bytes", None
            label, mkn = f"x ({m}, {k}) bf16, layer 0", (m, k)
        elif kernel == "fused_packed_matmul":
            ai, asc, codes, meta, dt = args
            m, k = ai.shape
            y = fused_packed_matmul(ai, asc, codes, meta, dt)
            ref = fused_packed_matmul_plain(ai, asc, codes, meta, dt)
            n = y.shape[1]
            err, ok = 0.0, torch.equal(_bits(y), _bits(ref))
            del y, ref
            t = timed(fused_packed_matmul, [args], iters=20)
            plain_ms = cuda_ms(fused_packed_matmul_plain, [args], iters=1,
                               warmup=1)
            bound_ms, bound_by, _ = _prefill_bound_ms(m, k, n)
            w = torch.randn(k, n, generator=torch.Generator(device=dev)
                            .manual_seed(seed), device=dev).to(torch.bfloat16)
            xb = torch.randn(m, k, device=dev).to(torch.bfloat16)
            library_ms = cuda_ms(torch.matmul, [(xb, w)], iters=20)
            del w, xb
            label, mkn = f"M={m} K={k} N={n} bf16 out, layer 0", (m, k, n)
        else:
            q, kc, vc, length, kw = args
            y = fused_decode_attention(q, kc, vc, length, **kw)
            ref = fused_decode_attention_plain(q, kc, vc, length,
                                               kw["n_kv_heads"], kw["d_head"],
                                               block_kv=kw.get("block_kv"))
            rf = ref.float()
            e = (y.float() - rf).abs()
            err = float(e.max())
            rel = float(torch.linalg.vector_norm(e) / torch.linalg.vector_norm(rf))
            ok = (bool((e <= 1e-3 + 2 ** -7 * rf.abs()).all())
                  and rel <= DRYRUN_ATTN_REL)
            ref_abs = (float(rf.abs().median()), float(rf.abs().max()))
            cap = kvcache.seq_capacity(kc)
            t = timed(lambda *a: fused_decode_attention(*a, **kw),
                      [(q, kc, vc, length)], iters=50)
            plain_ms = cuda_ms(lambda *a: fused_decode_attention_plain(
                *a, kw["n_kv_heads"], kw["d_head"], block_kv=kw.get("block_kv")),
                [(q, kc, vc, length)], iters=2, warmup=1)
            bound_ms = attention_bound_ms(kw["n_kv_heads"], kw["d_head"], length,
                                          None, cap, heads=q.shape[1])
            # the yardstick of the other kernel 3 rows: SDPA on the
            # dequantized bf16 K/V (every slot, not the same function)
            hkv, dh = kw["n_kv_heads"], kw["d_head"]
            dense = [(q[:, :, None],
                      kvcache.dequantize_kv(kc, hkv, dh).transpose(1, 2),
                      kvcache.dequantize_kv(vc, hkv, dh).transpose(1, 2))]
            library_ms = cuda_ms(torch.nn.functional.scaled_dot_product_attention,
                                 dense, iters=50)
            del dense
            bound_by = "bytes"
            label = (f"B={q.shape[0]} Hkv={kw['n_kv_heads']} H={q.shape[1]} "
                     f"D={kw['d_head']} S={cap} (length {int(length[0])}), "
                     f"layer 0")
            mkn = None
        print(f"  {kernel} {label}: {'bitwise' if kernel != 'fused_decode_attention' else f'max |d| {err:.3e}, relative norm {rel:.3e} (limit {DRYRUN_ATTN_REL:g}), |ref| median {ref_abs[0]:.3e} max {ref_abs[1]:.3e}'} "
              f"vs plain {'ok' if ok else 'FAILED'}; {_times(t)} plain_ms="
              f"{plain_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by}) library_ms="
              f"{'n/a' if library_ms is None else f'{library_ms:.5f}'}")
        check(ok, f"{kernel} {label}: disagrees with its plain version")
        launched = (caps.get(cap, 0) if mkn is None
                    else per_shape.get((kernel, mkn), 0))
        records.setdefault(kernel, {}).setdefault("dryrun", []).append(
            {**t, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms,
             "launches": launched, "max_abs_err": err, "arch": arch,
             "shape": label})
    check({k[0] for k in ops} == {"hif4_quantize", "fused_packed_matmul",
                                  "fused_decode_attention"},
          f"serve at {prompt}: kernels seen {sorted(ops)}")
    del sparams, ops, batch
    torch.cuda.empty_cache()


def phase_dryrun(dev, seed, records):
    import torch

    for arch, shape, batch, layers in DRYRUN_CELLS:
        t0 = time.perf_counter()
        dryrun_cell(dev, seed, arch, shape, batch, layers)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun_serve(dev, seed, records)
    print(f"  ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 15: the serve-cell harness at full width
# ---------------------------------------------------------------------------

# run_scenarios' rounds: best of 3 interleaved chunks, then 3 x 3 A/B
# rounds of the gate pair; paged cells max(2, 3 // 3) = 2 end-to-end rounds
# the reference's ratio gate hif4_over_bf16_kv_decode (benchmarks/matrix.py
# :119-120): the HiF4-KV step's rate at least 0.9x the bf16-KV one's
# (printed, not asserted: a smoke run is no benchmark)
HIF4_OVER_BF16_KV_LIMIT = 0.9
SCENARIO = {"repeats": 3,
            "gate_pairs": (("qwen-packed-hif4", "qwen-packed-hif4-guarded"),
                           ("qwen-packed-bf16", "qwen-packed-hif4"))}
SCENARIO_HIF4 = ("kv:hif4", "kv:no-fallback", "attn:fused_decode_attention",
                 "matmul:fused")
SCENARIO_PAGED = ("kv:hif4", "kv:no-fallback",
                  "attn:fused_paged_decode_attention", "matmul:fused")
# qwen1.5-0.5b's decode step: 24 layers of kernel 3 and of the KV append,
# 24 x 7 packed linears
QWEN_DECODE = {"fused_decode_attention": 24, "fused_decode_matmul": 24 * 7,
               "kv_append": 24}


def scenario_cells():
    """The eight cells: qwen1.5-0.5b packed HiF4 (and guarded, bf16 KV, qdq,
    paged, paged with the journal and a crash), whisper-tiny and
    mamba2-1.3b, at full width, batch 8, 8 new tokens."""
    from repro_torch.runtime.scenario import Scenario

    q = dict(arch="qwen1.5-0.5b", batch=8, prompt_len=480, new_tokens=8,
             reduced=False)
    return (
        Scenario("qwen-packed-hif4", impl="packed", kv_format="hif4",
                 expect=SCENARIO_HIF4, **q),
        Scenario("qwen-packed-hif4-guarded", impl="packed", kv_format="hif4",
                 guarded=True, expect=SCENARIO_HIF4, **q),
        Scenario("qwen-packed-bf16", impl="packed", kv_format="bf16",
                 expect=("kv:bf16", "kv:no-fallback", "attn:dense",
                         "matmul:fused"), **q),
        Scenario("qwen-qdq-bf16", impl="qdq", kv_format="bf16",
                 expect=("kv:bf16", "kv:no-fallback", "attn:dense",
                         "matmul:qdq"), **q),
        Scenario("qwen-packed-hif4-paged", impl="packed", kv_format="hif4",
                 paged=True, expect=SCENARIO_PAGED, **q),
        Scenario("qwen-packed-hif4-recovery", impl="packed", kv_format="hif4",
                 paged=True, journaled=True, recovery=True, decode_chunk=2,
                 expect=SCENARIO_PAGED, **q),
        Scenario("whisper-packed-hif4", arch="whisper-tiny", impl="packed",
                 kv_format="hif4", batch=8, prompt_len=1536, new_tokens=8,
                 reduced=False, expect=SCENARIO_HIF4),
        Scenario("mamba2-packed-hif4", arch="mamba2-1.3b", impl="packed",
                 kv_format="hif4", batch=8, prompt_len=512, new_tokens=8,
                 reduced=False, expect=("kv:bf16", "kv:fallback", "attn:none",
                                        "matmul:fused")),
    )


@contextlib.contextmanager
def scenario_recorder(seed: int):
    """Attribute the harness's kernel launches to its cells, and keep the
    operands of one attention call per cell.

    The harness's ``_build_cell`` is wrapped to draw each cell's weights
    from ``seed`` and to map its serving params to the cell; each decode
    chunk (the scan cells) and each ``serve_requests`` call (the paged
    cells) then adds the counters' change across it to its cell, per call.
    Kernel 3's calls keep a copy of the operands of the first call of each
    cell's second chunk (the first whose positions pass the cache's
    capacity); kernel 4's of each cell's 49th call (its third decode
    step), and the page sizes it ran at."""
    from repro_torch.core import engine
    from repro_torch.kernels import build
    from repro_torch.runtime import scenario, serve_loop

    rec = {"launches": {}, "chunks": {}, "k3": {}, "k4": {}, "pages": set(),
           "k4_calls": {}}
    owner, current = {}, [None]
    saved = (scenario._build_cell, scenario.serve_requests,
             serve_loop._decode_chunk, serve_loop._decode_chunk_guarded,
             engine.fused_decode_attention, engine.fused_paged_decode_attention)
    build_cell, serve_requests, chunk, chunk_guarded, k3, k4 = saved

    def copy(x):
        if isinstance(x, dict):
            return {k: v.clone() for k, v in x.items()}
        return x.clone() if hasattr(x, "clone") else x

    def counted(name, fn, *a, **kw):
        before = dict(build.LAUNCHES)
        outer, current[0] = current[0], name
        try:
            return fn(*a, **kw)
        finally:
            current[0] = outer
            delta = {k: build.LAUNCHES[k] - before[k] for k in before}
            rec["launches"].setdefault(name, []).append(delta)

    def rec_build(scn, device=None):
        cfg, ctx, sp = build_cell(scn, device, seed=seed)
        owner[id(sp)] = scn.name
        return cfg, ctx, sp

    def rec_serve(cfg, sp, *a, **kw):
        return counted(owner[id(sp)], serve_requests, cfg, sp, *a, **kw)

    def rec_chunk(fn):
        def wrapped(params, *a, **kw):
            name = owner.get(id(params))
            if name is None:             # inside serve_requests: counted there
                return fn(params, *a, **kw)
            out = counted(name, fn, params, *a, **kw)
            rec["chunks"][name] = rec["chunks"].get(name, 0) + 1
            return out
        return wrapped

    def rec_k3(q, k, v, length, **kw):
        name = current[0]
        if rec["chunks"].get(name) == 1 and name not in rec["k3"]:
            rec["k3"][name] = (copy(q), copy(k), copy(v), copy(length), kw)
        return k3(q, k, v, length, **kw)

    def rec_k4(q, kp, vp, pages, length, **kw):
        name = current[0]
        rec["pages"].add(kp["codes"].shape[-1])
        n = rec["k4_calls"][name] = rec["k4_calls"].get(name, 0) + 1
        if n == 49:
            rec["k4"][name] = (copy(q), copy(kp), copy(vp), copy(pages),
                               copy(length), kw)
        return k4(q, kp, vp, pages, length, **kw)

    scenario._build_cell, scenario.serve_requests = rec_build, rec_serve
    serve_loop._decode_chunk = rec_chunk(chunk)
    serve_loop._decode_chunk_guarded = rec_chunk(chunk_guarded)
    engine.fused_decode_attention = rec_k3
    engine.fused_paged_decode_attention = rec_k4
    try:
        yield rec
    finally:
        (scenario._build_cell, scenario.serve_requests,
         serve_loop._decode_chunk, serve_loop._decode_chunk_guarded,
         engine.fused_decode_attention,
         engine.fused_paged_decode_attention) = saved


def _attention_vs_plain(label, out, ref) -> float:
    err = (out.float() - ref.float()).abs()
    worst = float(err.max())
    check(bool((err <= 1e-3 + 2 ** -7 * ref.float().abs()).all()),
          f"{label}: max |d| {worst} beyond rtol=2^-7, atol=1e-3 of the plain "
          f"version")
    return worst


def phase_scenario(dev, seed, records):
    """The serve-cell harness (repro_torch.runtime.scenario.run_scenarios)
    on the card at full width: every cell's probed dispatch holds and
    agrees with the kernels its decode launched; kernel 4 at 16-token pages
    and kernel 3 past the cache's capacity held against their plain
    versions on the operands the cells gave them; recovery bitwise; no
    cell's decode step below its bytes over the card's memory rate. One
    JSON line per cell."""
    import torch
    from repro_torch.core import kvcache
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_attention import (
        fused_decode_attention, fused_decode_attention_plain,
        fused_paged_decode_attention, fused_paged_decode_attention_plain)
    from repro_torch.runtime.scenario import run_scenarios

    cells = scenario_cells()
    t0 = time.perf_counter()
    with scenario_recorder(seed) as rec:
        build.reset_launches()
        out = run_scenarios(cells, repeats=SCENARIO["repeats"],
                            gate_pairs=SCENARIO["gate_pairs"], device=dev,
                            log=lambda m: print(f"  {m}"))
        totals = dict(build.LAUNCHES)
    print(f"  run_scenarios: {len(out)} cells in {time.perf_counter() - t0:.1f} "
          f"s; launches {totals}; kernel 4 page sizes {sorted(rec['pages'])}")
    recs = {r["name"]: r for r in out}
    for scn in cells:
        r = recs[scn.name]
        check(r["dispatch_ok"], f"{scn.name}: dispatch {r['dispatch']} fails "
              f"{r['dispatch_failures']}")
        calls = rec["launches"].get(scn.name, [])
        got = {k: sum(c[k] for c in calls) for k in totals}
        attn, matmul = r["dispatch"]["attn"], r["dispatch"]["matmul"]
        print(f"  {scn.name}: attn {attn['route']} (fused {attn.get('fused')}), "
              f"matmul {matmul['route']}; decode launches over {len(calls)} "
              f"calls: { {k: v for k, v in got.items() if v} }")
        check(len(calls) > 0, f"{scn.name}: no decode call was seen")
        k3n, k4n = got["fused_decode_attention"], got["fused_paged_decode_attention"]
        if attn["route"] == "fused_decode_attention":
            check(attn["fused"] and k3n > 0 and k4n == 0,
                  f"{scn.name}: probe says kernel 3; launched {got}")
        elif attn["route"] == "fused_paged_decode_attention":
            check(attn["fused"] and k4n > 0 and k3n == 0,
                  f"{scn.name}: probe says kernel 4; launched {got}")
        else:
            check(k3n == k4n == 0, f"{scn.name}: probe says {attn['route']}; "
                  f"launched {got}")
        # one append a layer a decode step on a HiF4 cache, beside each
        # kernel 4 call, or each self-attention call of kernel 3 (whisper's
        # decoder also reads its cross cache through kernel 3, which appends
        # nothing); none on a bf16 cache
        appends = k4n + (k3n // 2 if r["family"] == "audio" else k3n)
        check(got["kv_append"] == appends and (appends > 0) == (
            r["kv_format_resolved"] == "hif4"),
              f"{scn.name}: {got['kv_append']} KV appends, kernels 3 / 4 "
              f"launched {k3n} / {k4n} on a {r['kv_format_resolved']} cache")
        if matmul["route"] == "fused":
            check(got["fused_decode_matmul"] > 0,
                  f"{scn.name}: probe says fused; kernel 2's decode form never "
                  f"launched: {got}")
        else:
            check(not any(got.values()), f"{scn.name}: probe says "
                  f"{matmul['route']}; launched {got}")
        if scn.arch == "qwen1.5-0.5b" and not scn.paged and scn.impl == "packed":
            want = {k: n * scn.new_tokens for k, n in QWEN_DECODE.items()}
            if scn.kv_format != "hif4":
                want["fused_decode_attention"] = want["kv_append"] = 0
            check(all({k: c[k] for k in want} == want for c in calls),
                  f"{scn.name}: a chunk's launches differ from {want}: "
                  f"{[{k: c[k] for k in want} for c in calls]}")
    check(rec["pages"] == {16}, f"kernel 4 ran at page sizes {rec['pages']}")
    # kernel 4 on the paged cells' pools, kernel 3 past the capacity: held
    # against their plain versions on the operands the cells gave them
    for name, (q, kp, vp, pages, length, kw) in sorted(rec["k4"].items()):
        y = fused_paged_decode_attention(q, kp, vp, pages, length, **kw)
        ref = fused_paged_decode_attention_plain(q, kp, vp, pages, length,
                                                 kw["n_kv_heads"], kw["d_head"])
        err = _attention_vs_plain(f"{name}: kernel 4", y, ref)
        print(f"  {name}: kernel 4 at P={kp['codes'].shape[-1]}, "
              f"{pages.shape[1]} pages a slot, lengths {length.tolist()}: max "
              f"|d| {err:.3e} vs plain (rtol 2^-7, atol 1e-3)")
    check(set(rec["k4"]) == {c.name for c in cells if c.paged},
          f"kernel 4 operands kept for {sorted(rec['k4'])}")
    for name, (q, kc, vc, length, kw) in sorted(rec["k3"].items()):
        cap = kvcache.seq_capacity(kc)
        y = fused_decode_attention(q, kc, vc, length, **kw)
        ref = fused_decode_attention_plain(q, kc, vc, length, kw["n_kv_heads"],
                                           kw["d_head"], block_kv=kw.get("block_kv"))
        err = _attention_vs_plain(f"{name}: kernel 3", y, ref)
        print(f"  {name}: kernel 3 at capacity {cap} received lengths "
              f"{sorted(set(length.tolist()))} (the write clamped at slot "
              f"{cap - 1}): max |d| {err:.3e} vs plain")
    for name in (c.name for c in cells if c.arch == "qwen1.5-0.5b"
                 and c.kv_format == "hif4" and not c.paged):
        _, kc, _, length, _ = rec["k3"][name]
        check(int(length.min()) > kvcache.seq_capacity(kc),
              f"{name}: kernel 3's kept call is not past the capacity")
    torch.cuda.synchronize()
    card = card_line()
    for scn in cells:
        r = recs[scn.name]
        ro = r["roofline"]
        bound_ms = ro["bytes_per_step"] / HBM_BYTES_PER_S * 1e3
        check(r["decode_step_ms"] >= bound_ms, f"{scn.name}: decode step "
              f"{r['decode_step_ms']} ms below its bytes bound {bound_ms} ms")
        line = {"cell": scn.name, "timing": r["timing"],
                "decode_step_ms": r["decode_step_ms"],
                "prefill_ms": r["prefill_ms"], **ro,
                "bytes_bound_ms": bound_ms,
                "bound_share": bound_ms / r["decode_step_ms"],
                "dispatch_ok": r["dispatch_ok"]}
        if "gate_timing" in r:
            line["gate_timing"] = r["gate_timing"]
        if "recovery" in r:
            line["recovery"] = r["recovery"]
        print(f"  scenario {json.dumps(line)} {card}")
    ab = recs["qwen-packed-hif4"]["gate_timing"]["qwen-packed-bf16"]
    ratio = ab["baseline_ms"] / ab["subject_ms"]
    print(f"  hif4_over_bf16_kv_decode (A/B): bf16 {ab['baseline_ms']} ms / "
          f"HiF4 {ab['subject_ms']} ms = {ratio:.4f} (the reference's limit "
          f"{HIF4_OVER_BF16_KV_LIMIT}: {'meets' if ratio >= HIF4_OVER_BF16_KV_LIMIT else 'below'}"
          f"; printed, not asserted) {card}")
    rcv = recs["qwen-packed-hif4-recovery"]["recovery"]
    check(rcv["crashed"] and rcv["bitwise"], f"recovery cell: {rcv}")


# ---------------------------------------------------------------------------
# phase 16: the examples (examples/torch_*.py) on the card
# ---------------------------------------------------------------------------

# the serve example at its defaults (qwen1.5-0.5b, 120 steps, 16 tokens),
# then the two archs no other phase serves, at (steps, new tokens); the
# train example's steps (one checkpoint at step 50)
EXAMPLES = {"serve_archs": (("qwen1.5-4b", 8, 4), ("phi3.5-moe-42b-a6.6b", 8, 4)),
            "train_steps": 60}
EXAMPLES_OUT = ROOT / ".train" / "examples"
# the PTQ example's HiGPTQ layer-output error card vs CPU on the same
# inputs, relative (the Hessian's matmuls and the per-row updates sum in
# another order on the card). Measured 1.815e-3 with 99.725% of the HiGPTQ
# weights equal (NVIDIA H100 80GB HBM3, 700.00 W); the limit is 2.75x that
PTQ_CARD_REL = 5e-3


def _example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_quickstart(dev):
    """The tour on the card: §3 equal, §4 (kernel 1 then kernel 5's decode
    form at M = 32) bitwise its plain version on the card and on the CPU,
    one launch of each, timed beside the plain version."""
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.bfp_matmul import (
        bfp_decode_matmul, bfp_decode_matmul_plain)
    from repro_torch.kernels.hif4_quant import hif4_quantize

    mod = _example("torch_quickstart")
    inputs = mod.draw_inputs()
    build.reset_launches()
    lines, v = mod.tour(inputs, dev)
    torch.cuda.synchronize()
    launches, shapes = dict(build.LAUNCHES), dict(build.SHAPE_LAUNCHES)
    print("\n".join(f"  | {x}" for x in lines))
    check(v["fixed_point"] == v["dequant"]
          and any(x.endswith("equal: True") for x in lines),
          f"the fixed-point dot {v['fixed_point']} != {v['dequant']}")
    m, k, n = inputs["m"].shape[0], inputs["m"].shape[1], inputs["w"].shape[1]
    want = {key: 0 for key in launches}
    want.update(hif4_quantize=1, bfp_matmul_quantized=1, bfp_decode_matmul=1)
    print(f"  launches {launches}; per shape {shapes}")
    check(launches == want, f"quickstart §4 launched {launches}, want {want}")
    check(shapes.get(("bfp_decode_matmul", (m, k, n))) == 1,
          f"the decode form did not run at M={m}: {shapes}")
    with plain_versions():
        y_plain = ops.matmul(inputs["m"].to(dev), inputs["w"].to(dev))
    _, v_cpu = mod.tour(inputs, torch.device("cpu"))
    torch.cuda.synchronize()
    y = v["y"]
    check(torch.equal(y.view(torch.int32), y_plain.view(torch.int32))
          and torch.equal(y.cpu().view(torch.int32), v_cpu["y"].view(torch.int32)),
          f"quickstart §4 on the card is not bitwise its plain version: "
          f"{int((y != y_plain).sum())} outputs differ on the card, "
          f"{int((y.cpu() != v_cpu['y']).sum())} against the CPU")
    print(f"  §4 (M={m} K={k} N={n}, f32 operands): bitwise the plain versions "
          f"on the card and on the CPU; relative error {v['rel']:.3%} (CPU "
          f"{v_cpu['rel']:.3%})")

    # kernel 5's decode form alone at this shape, and ops.matmul (kernel 1,
    # then the decode form) beside its plain version, on rotating copies
    gen = torch.Generator(device=dev).manual_seed(23)
    mats = [(torch.randn(m, k, generator=gen, device=dev) * 0.1,
             torch.randn(k, n, generator=gen, device=dev) * 0.05)
            for _ in range(L2_ROTATION)]
    quant = [(*hif4_quantize(a), w) for a, w in mats]
    t = timed(bfp_decode_matmul, quant)
    plain_ms = cuda_ms(bfp_decode_matmul_plain, quant, iters=20)
    library_ms = cuda_ms(torch.matmul, [(a.to(torch.bfloat16), w.to(torch.bfloat16))
                                        for a, w in mats])
    bound_ms, bound_by, nbytes = _head_decode_bound_ms(m, k, n, w_bytes=4)
    print(f"  bfp_decode_matmul M={m} K={k} N={n} f32 weight (the quickstart's "
          f"§4; the decode body at 32 rows): {_times(t)} plain_ms="
          f"{plain_ms:.5f} bound_ms={bound_ms:.7f} ({bound_by}: {nbytes} B) "
          f"library_ms={library_ms:.5f} (torch.matmul bf16, not the same "
          f"function); {card_line()}")
    whole = cuda_ms(ops.matmul, mats)
    with plain_versions():
        whole_plain = cuda_ms(ops.matmul, mats, iters=20)
    print(f"  ops.matmul (kernel 1, then the decode form): kernel_ms="
          f"{whole:.6f}, its plain versions on the card {whole_plain:.5f}")


def examples_ptq(dev):
    """The PTQ example on the card and on the CPU, the same inputs."""
    import torch

    mod = _example("torch_ptq_higptq")
    inputs = mod.draw_inputs()
    t0 = time.perf_counter()
    lines, v = mod.ptq_rows(inputs, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    print("\n".join(f"  | {x}" for x in lines))
    _, c = mod.ptq_rows(inputs, torch.device("cpu"))
    rel = abs(v["higptq"] - c["higptq"]) / c["higptq"]
    same = float((v["wq_g"].cpu() == c["wq_g"]).float().mean())
    print(f"  card {card_s:.2f} s; CPU: direct-cast {c['direct']:.6f}, HiGPTQ "
          f"{c['higptq']:.6f}; card: {v['direct']:.6f}, {v['higptq']:.6f}; "
          f"HiGPTQ error card vs CPU {rel:.3e} relative (limit {PTQ_CARD_REL}), "
          f"{100 * same:.3f}% of the weights equal")
    check(v["higptq"] < v["direct"], "HiGPTQ is not below the direct cast")
    check(abs(v["direct"] - c["direct"]) <= 1e-5 * c["direct"],
          "the direct cast's error differs card vs CPU")
    check(rel <= PTQ_CARD_REL, f"HiGPTQ card vs CPU {rel} > {PTQ_CARD_REL}")


@contextlib.contextmanager
def _serve_recorder(mod):
    """Wrap the serve example's ``serve`` and ``serve_table``: the launches
    of each serve, in order (``calls``), and the table's arguments and rows
    (``args``, ``rows``)."""
    import torch
    from repro_torch.kernels import build

    rec = {"calls": []}
    serve, serve_table = mod.serve, mod.serve_table

    def counted(*a, **kw):
        build.reset_launches()
        out = serve(*a, **kw)
        torch.cuda.synchronize()
        rec["calls"].append(dict(build.LAUNCHES))
        return out

    def table(*a, **kw):
        lines, rows = serve_table(*a, **kw)
        rec.update(args=a, rows=rows)
        return lines, rows

    mod.serve, mod.serve_table = counted, table
    try:
        yield rec
    finally:
        mod.serve, mod.serve_table = serve, serve_table


PACKED_ROWS = ("hif4 (impl=packed)", "hif4 + hif4 kv cache",
               "policy: sens-fallback")


def _check_example_rows(label, cfg, rows, calls, new_tokens):
    """Every row served; bf16 at 100.0%; the qdq rows launched nothing, the
    packed rows kernel 1 and kernel 2 in both forms at 0.5625 B/value, the
    HiF4-KV row also kernel 3 and the KV append once a layer a decode step
    where the cache takes it (the bf16-KV rows neither)."""
    modes = [r["mode"] for r in rows]
    check(modes == ["bf16", "hif4", "nvfp4", "nvfp4_pts", "mxfp4", *PACKED_ROWS]
          and len(calls) == len(rows), f"{label}: rows {modes}, {len(calls)} serves")
    check(rows[0]["agree"] == 100.0, f"{label}: bf16 {rows[0]['agree']}")
    steps = (new_tokens - 1) * cfg.n_layers
    for r, n in zip(rows, calls):
        ran = {k: c for k, c in n.items() if c}
        print(f"  {label} {r['mode']}: {r['agree']:.1f}%, launches {ran}")
        if r["mode"] not in PACKED_ROWS:
            check(not ran, f"{label} {r['mode']}: launched {ran}")
            continue
        check(n["hif4_quantize"] > 0 and n["fused_decode_matmul"] > 0
              and n["fused_packed_matmul"] > n["fused_decode_matmul"],
              f"{label} {r['mode']}: not kernel 1 and kernel 2 in both forms: {n}")
        check(r["bytes_per_value"] == 0.5625,
              f"{label} {r['mode']}: {r['bytes_per_value']} B/value")
        append = steps if r["serve_cfg"].kv_format == "hif4" else 0
        attend = append if _kernel3_eligible(cfg) else 0
        check(n["fused_decode_attention"] == attend and n["kv_append"] == append,
              f"{label} {r['mode']}: kernel 3 {n['fused_decode_attention']}, "
              f"KV appends {n['kv_append']}, want {attend} and {append}")


def _kernel3_eligible(cfg) -> bool:
    """Whether a HiF4 KV cache of ``cfg`` takes kernel 3 (the engine's
    ``kernel_compatible``): whole 64-groups, no bf16 tail, and head blocks
    dividing the KV heads (phi3.5-moe reduced has one KV head of 32: all
    tail, the plain recurrence)."""
    from repro_torch.kernels.fused_attention import heads_per_block

    a = cfg.attn
    return (a.n_kv_heads * a.d_head % 64 == 0
            and a.n_kv_heads % heads_per_block(a.d_head) == 0)


def examples_serve(dev):
    """The serve example's ``main`` at its defaults on the card (trained on
    the card, every row with its launches, the HiF4-KV cache's bytes a
    token), the packed rows' tokens against ``serve_table`` on the CPU on
    the same card-trained params; then ``main`` for qwen1.5-4b and
    phi3.5-moe-42b-a6.6b."""
    import torch
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        build_decode_cache, kv_cache_bytes, serving_ctx)

    mod = _example("torch_serve_quantized")
    t0 = time.perf_counter()
    with _serve_recorder(mod) as rec:
        mod.main([])
    card_s = time.perf_counter() - t0
    cfg, params, prompts, new, _ = rec["args"]
    rows = rec["rows"]
    _check_example_rows(cfg.name, cfg, rows, rec["calls"], new)
    check(new == 16 and cfg.name == "qwen1.5-0.5b-smoke"
          and _kernel3_eligible(cfg), f"the defaults: {cfg.name}, {new} tokens")

    kv = next(r for r in rows if r["mode"] == "hif4 + hif4 kv cache")
    _, cache = build_decode_cache(
        cfg, kv["params"], {k: v.to(dev) for k, v in prompts.items()},
        serving_ctx(kv["ctx"]), kv["serve_cfg"])
    nbytes, slots = kv_cache_bytes(cache)
    print(f"  the HiF4 KV cache on the card: {nbytes} B over {slots} slots = "
          f"{nbytes / slots} B a token (the row prints {kv['kv_bytes']})")
    check(nbytes == kv["kv_bytes"] * slots, "the HiF4 KV cache's bytes a token")
    del cache

    # the CPU's table on the same (card-trained) params
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    _, rows_cpu = mod.serve_table(
        cfg, _map_tensors(params, lambda x: x.detach().cpu()), prompts, new, cpu)
    cpu_s = time.perf_counter() - t0
    for r, rc in zip(rows, rows_cpu):
        if r["mode"] not in PACKED_ROWS:
            continue
        ctx = rc["ctx"]
        if ctx.plan is None:
            ctx = dataclasses.replace(ctx, plan=lm.quant_plan(cfg, ctx.quant))
        _check_tokens(f"{r['mode']}: card vs cpu", r["tokens"].cpu(), "cpu",
                      {"cpu": (None, rc["tokens"], cpu)}, cfg, rc["params"],
                      ctx, prompts["tokens"], kv_format=rc["serve_cfg"].kv_format)
    print(f"  main() at its defaults {card_s:.1f} s on the card; the CPU's "
          f"table {cpu_s:.1f} s")

    for arch, steps, new in EXAMPLES["serve_archs"]:
        t0 = time.perf_counter()
        with _serve_recorder(mod) as rec:
            mod.main(["--arch", arch, "--steps", str(steps),
                      "--new-tokens", str(new)])
        cfg = rec["args"][0]
        _check_example_rows(arch, cfg, rec["rows"], rec["calls"], new)
        print(f"  {arch}: main() in {time.perf_counter() - t0:.1f} s")


def examples_train(dev):
    """The train example's two runs on the card into a fresh checkpoint
    directory: falling losses, the step-50 checkpoint, no kernel launch."""
    import shutil

    import torch
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build

    mod = _example("torch_train_quantized_lm")
    steps = EXAMPLES["train_steps"]
    shutil.rmtree(EXAMPLES_OUT, ignore_errors=True)
    ckpt = str(EXAMPLES_OUT / "ckpt")
    cfg = get_arch("qwen3-4b").reduced()
    build.reset_launches()
    for fmt in ("none", "hif4"):
        hist = mod.train_run(cfg, fmt, steps, ckpt, dev)
        print(f"  | {mod.run_line(fmt, hist, steps)}")
        losses = hist["loss"]
        check(len(losses) == steps and all(math.isfinite(x) for x in losses),
              f"{fmt}: {len(losses)} losses")
        check(sum(losses[-5:]) < sum(losses[:5]), f"{fmt}: the loss did not fall")
        d = Path(f"{ckpt}_{fmt}")
        check((d / f"step_{mod.CHECKPOINT_EVERY:08d}").is_dir()
              and latest_step(str(d)) == steps,
              f"{fmt}: checkpoints {sorted(p.name for p in d.iterdir())}")
    torch.cuda.synchronize()
    check(not any(build.LAUNCHES.values()), f"training launched {build.LAUNCHES}")
    print(f"  checkpoints at steps {mod.CHECKPOINT_EVERY} and {steps} in "
          f"{EXAMPLES_OUT.relative_to(ROOT)}; no kernel launch; {card_line()}")


def phase_examples(dev):
    """The four examples on the card (examples/torch_*.py)."""
    t0 = time.perf_counter()
    for label, fn in (("quickstart", lambda: examples_quickstart(dev)),
                      ("ptq_higptq", lambda: examples_ptq(dev)),
                      ("serve_quantized", lambda: examples_serve(dev)),
                      ("train_quantized_lm", lambda: examples_train(dev))):
        t1 = time.perf_counter()
        print(f"  -- {label}")
        fn()
        print(f"  -- {label} in {time.perf_counter() - t1:.1f} s")
    print(f"  the four examples in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of repro_torch")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights and prompts; granite's paged trace in "
                         "phase families holds on seed 0 only")
    ap.add_argument("--only", default="",
                    help="comma list of phases to run (kernels,serve,pallas,"
                         "e2e,paged,robust,families,ssm,encdec,calibrate,"
                         "train,dryrun,scenario,examples); default all")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    # before cuBLAS first initializes: phase train runs the train loop under
    # torch's deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
                                   check_decode_matmul(dev, records),
                                   check_attention(dev, records),
                                   check_paged_attention(dev, records),
                                   check_bfp_matmul(dev, records),
                                   check_head_matmul(dev, records),
                                   check_kv_append(dev, records))),
              ("serve", lambda: phase_serve(dev, args.seed, records)),
              ("pallas", lambda: phase_pallas(dev, args.seed, records)),
              ("e2e", lambda: phase_e2e(dev, args.seed)),
              ("paged", lambda: phase_paged(dev, args.seed, records)),
              ("robust", lambda: phase_robust(dev, args.seed, records)),
              ("families", lambda: phase_families(dev, args.seed, records)),
              ("ssm", lambda: phase_ssm(dev, args.seed, records)),
              ("encdec", lambda: phase_encdec(dev, args.seed, records)),
              ("calibrate", lambda: phase_calibrate(dev, args.seed)),
              ("train", lambda: phase_train(dev, args.seed)),
              ("dryrun", lambda: phase_dryrun(dev, args.seed, records)),
              ("scenario", lambda: phase_scenario(dev, args.seed, records)),
              ("examples", lambda: phase_examples(dev))]
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
    names = ["hif4_quantize", "fused_packed_matmul", "fused_decode_matmul",
             "fused_decode_attention", "fused_paged_decode_attention",
             "bfp_matmul_quantized", "bfp_decode_matmul", "kv_append"]
    print(f"kernels: {json.dumps(names)}")
    if not only:
        print(json.dumps({"kernels": [dict(records[n], kernel_ms=records[n]["ms"])
                                      for n in names]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
