#!/usr/bin/env python3
"""Time the port's prefill linears on a CUDA card, for one source tree.

    python3 tools/torch_prefill_linears.py [--src SRC] [--label NAME]
                                           [--serve] [--ptxas]

qwen1.5-0.5b's quantized linears at its prefill (batch 8 x prompt 480 =
3 840 rows): wq/wk/wv/wo (K=1024, N=1024), wg/wu (K=1024, N=2816) and the
MLP's wo (K=2816, N=1024). Per shape it prints one JSON line with
``kernel2`` (kernel 2's prefill form called directly, f32 out, as every
tree can call it), ``linear`` (``repro_torch.core.engine.matmul`` on a
packed HiF4 weight under impl packed, bf16 in and out: kernel 1, kernel 2
and whatever cast the tree does) and the launches of one linear call; then
kernel 5 (``bfp_matmul_quantized``) at M=3840, K=1024, N=2816. Each timing
is ``kernel_ms`` (CUDA events around the eager loop), ``device_ms`` (the
same calls captured in a CUDA graph and replayed) and ``host_us`` (host
clock per call, no synchronize in the window), over operands rotated
through more than the 50 MB L2 (``chip_smoke.py``'s helpers).

``--serve`` adds the serve prefill: full-width qwen1.5-0.5b under paper-iv,
impl packed, HiF4 KV, random weights from seed 0, batch 8 x prompt 480,
the wall ms of six runs after a warm-up, and one run under
``torch.profiler``: device busy ms, the device's idle share, and the top
``--top`` device ops and host operators. ``--ptxas`` recompiles the
tree's ``fused_matmul.cu`` and ``bfp_matmul.cu`` with ``-Xptxas -v`` and
prints each kernel's registers, stack and spills, and the count of
``GMMA`` (tensor-core) instructions in the built libraries'
``cuobjdump -sass``. ``--src`` names the ``src`` directory whose
``repro_torch`` is imported (default: this checkout's), so one call on the
card can time two trees in turns. The last line is the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
M = 3840                                         # batch 8 x prompt 480
SHAPES = ((1024, 1024), (1024, 2816), (2816, 1024))   # (K, N)


def _ptxas(build) -> None:
    """Registers, stack and spills per kernel (ptxas -v), and the GMMA
    instructions in each built library."""
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("fused_matmul", "bfp_matmul"):
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   str(build.CSRC), "-o", str(Path(tmp) / f"{name}.so"),
                   str(build.CSRC / f"{name}.cu")]
            log = subprocess.run(cmd, capture_output=True, text=True).stderr
            entry = None
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    entry = m.group(1)
                elif entry and ("registers" in line or "spill" in line):
                    print(json.dumps({"source": f"{name}.cu", "entry": entry,
                                      "ptxas": line.strip()}))
                elif "C75" in line:               # wgmma pipeline notes
                    print(json.dumps({"source": f"{name}.cu",
                                      "ptxas": line.strip()[:160]}))
            sass = subprocess.run(
                [str(Path(build.nvcc()).parent / "cuobjdump"), "-sass",
                 str(build._target(name))], capture_output=True, text=True).stdout
            print(json.dumps({"library": f"{name}.cu", "gmma_instructions":
                              sum("GMMA" in ln for ln in sass.splitlines())}))


def _device_activity():
    """``repro_torch.launch.profile.device_activity`` of this checkout,
    whichever tree ``--src`` imports, so both trees are measured alike."""
    spec = importlib.util.spec_from_file_location(
        "_measuring_profile", ROOT / "src/repro_torch/launch/profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_activity


def _serve_prefill(cs, tree: str, dev, top: int) -> None:
    """The serve prefill (what ``serve`` times as ``prefill_s``: prefill,
    the KV cache packed once, padded, the first token's argmax): wall ms of
    six runs after a warm-up, then one run under ``torch.profiler`` with its
    device busy time (the union of the device's activity intervals), idle
    share of the wall time, device ops, and the top device ops and host
    operators."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import (
        ServeConfig, build_decode_cache, prepare_params_for_serving,
        serving_ctx)

    cfg = get_arch("qwen1.5-0.5b")
    ctx = cs.serving_setup(cfg)
    sctx = serving_ctx(ctx)
    params = lm.init_params(cfg, 0, device="cpu")
    sparams = prepare_params_for_serving(params, cfg, ctx.plan, device=dev)
    del params
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 480), generator=torch.
                                     Generator().manual_seed(1)).to(dev)}
    sc = ServeConfig(max_new_tokens=2)

    def prefill():
        logits, cache = build_decode_cache(cfg, sparams, batch, sctx, sc)
        token = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        return token, cache

    runs = []
    for i in range(7):                           # the first warms up
        t0 = time.perf_counter()
        prefill()
        if i:
            runs.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prefill()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, kernels = _device_activity()(prof.events())
    events = prof.key_averages()
    print(json.dumps({
        "tree": tree, "serve_prefill_ms": runs, "batch": 8, "prompt": 480,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": 1 - busy / wall_ms,
        "device_ops": sum(c for _, c, _ in kernels),
        "top_device_ms": [[name[:80], c, ms] for name, c, ms in kernels[:top]],
        "top_host_self_ms": [
            [e.key[:80], e.count, e.self_cpu_time_total / 1e3]
            for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                            reverse=True)[:top]]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the times are the card's", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import engine
    from repro_torch.core.qlinear import PackedW, QuantConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.bfp_matmul import bfp_matmul_quantized
    from repro_torch.kernels.fused_matmul import fused_packed_matmul
    from repro_torch.kernels.hif4_quant import hif4_quantize

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    tree = args.label or args.src
    ectx = engine.EngineCtx(QuantConfig(fmt="hif4", impl="packed"))
    gen = torch.Generator(device=dev).manual_seed(0)

    def linear(x, pw):
        return engine.matmul(x, pw, ectx)

    def kernel2(ai, asc, pw):
        return fused_packed_matmul(ai, asc, pw.codes, pw.meta)

    for k, n in SHAPES:
        ops = []
        for _ in range(8):                       # > the 50 MB L2 in all
            w = (torch.randn(k, n, generator=gen, device=dev) * 0.02)
            pw = PackedW.from_dense(w.to(torch.bfloat16)).to_kernel_layout()
            x = torch.randn(M, k, generator=gen, device=dev).to(torch.bfloat16)
            ops.append((x, pw, *hif4_quantize(x)))
        build.reset_launches()
        linear(ops[0][0], ops[0][1])
        torch.cuda.synchronize()
        launches = {key: v for key, v in build.LAUNCHES.items() if v}
        print(json.dumps({
            "tree": tree, "shape": [M, k, n], "launches_per_linear": launches,
            "kernel2": cs.timed(kernel2, [(o[2], o[3], o[1]) for o in ops],
                                iters=60),
            "linear": cs.timed(linear, [o[:2] for o in ops], iters=60)}),
            flush=True)
        del ops
    ops = [cs._lm_head_operands(M, 1024, 2816, gen, dev)[:4] for _ in range(8)]
    print(json.dumps({"tree": tree, "kernel5": [M, 1024, 2816],
                      **cs.timed(bfp_matmul_quantized, ops, iters=60)}),
          flush=True)
    del ops
    if args.serve:
        _serve_prefill(cs, tree, dev, args.top)
    if args.ptxas:
        _ptxas(build)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
