#!/usr/bin/env python3
"""Time the port's quantized LM head on a CUDA card, for one source tree.

    python3 tools/torch_head_matmul.py [--src SRC] [--label NAME] [--ptxas]
                                       [--rows 8,32]

qwen1.5-0.5b's tied head under the dense pallas route: x (M, 1024) bf16
against the embedding (151 936, 1024) bf16 handed over as ``embed.T``.
Per M it prints one JSON line with ``kernel5`` (``bfp_matmul_quantized``
on pre-quantized operands, as every tree can call it), ``pair`` (kernel 1
on the embedding, then kernel 5: the head's weight route before the decode
form), ``decode_form`` (``bfp_decode_matmul``, where the tree has it) and
``head`` (``kernels.ops.matmul``: the whole head as the engine calls it,
kernel 1 on x included), with the launches of one head call. Each timing is
``kernel_ms`` (CUDA events around the eager loop), ``device_ms`` (the same
calls captured in a CUDA graph and replayed) and ``host_us`` (host clock
per call, no synchronize in the window), over two copies of the embedding
(622 MB, more than the 50 MB L2; ``chip_smoke.py``'s helpers), beside the
bytes bounds and Algorithm 1's issue floor (kernel 1's SASS instructions
per lane, ``cuobjdump``). ``--ptxas`` recompiles the tree's
``bfp_matmul.cu`` and ``bfp_decode_matmul.cu`` with ``-Xptxas -v`` and
prints each decode kernel's registers, stack and spills. ``--src`` names
the ``src`` directory whose ``repro_torch`` is imported (default: this
checkout's), so one call on the card can time two trees in turns. The last
line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _ptxas(build) -> None:
    """Registers, stack and spills of every decode kernel (ptxas -v)."""
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("bfp_matmul", "bfp_decode_matmul"):
            if not (build.CSRC / f"{name}.cu").exists():
                continue
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   str(build.CSRC), "-o", str(Path(tmp) / f"{name}.so"),
                   str(build.CSRC / f"{name}.cu")]
            log = subprocess.run(cmd, capture_output=True, text=True).stderr
            entry = None
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    entry = m.group(1)
                elif entry and "decode" in entry and (
                        "registers" in line or "spill" in line):
                    print(json.dumps({"source": f"{name}.cu", "entry": entry,
                                      "ptxas": line.strip()}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--rows", default="8")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the times are the card's", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import bfp_matmul as TB
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.hif4_quant import hif4_quantize

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    tree = args.label or args.src
    n, k = cs.EMBED_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    embeds = [(torch.randn(n, k, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16) for _ in range(2)]
    per_lane = cs._sass_instructions("hif4_quant", "hif4_quantize_kernel",
                                     "nv_bfloat16", "Lb1E")

    def pair(ai, asc, w):
        wi, wsc = hif4_quantize(w.T)
        return TB.bfp_matmul_quantized(ai, asc, wi.T, wsc.T)

    for m in (int(r) for r in args.rows.split(",")):
        xs = [torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
              for _ in embeds]
        quant = [hif4_quantize(x) for x in xs]
        pre = [(*q, *hif4_quantize(e)) for q, e in zip(quant, embeds)]
        k5_args = [(ai, asc, wi.T, wsc.T) for ai, asc, wi, wsc in pre]
        del pre
        w_args = [(*q, e.T) for q, e in zip(quant, embeds)]
        build.reset_launches()
        ops.matmul(xs[0], embeds[0].T)
        torch.cuda.synchronize()
        row = {"tree": tree, "shape": [m, k, n],
               "launches_per_head": {key: v for key, v in build.LAUNCHES.items()
                                     if v},
               "kernel5": cs.timed(TB.bfp_matmul_quantized, k5_args, iters=30),
               "pair": cs.timed(pair, w_args, iters=30),
               "head": cs.timed(ops.matmul, [(x, e.T) for x, e in zip(
                   xs, embeds)], iters=30),
               "kernel5_bound_ms": cs._group_matmul_bound_ms(m, k, n)[0],
               "decode_form_bound_ms": cs._head_decode_bound_ms(m, k, n)[0],
               "issue_floor_ms": cs._issue_floor_ms(n * k // 8, per_lane),
               "sass_per_lane": per_lane}
        if hasattr(TB, "bfp_decode_matmul"):
            row["decode_form"] = cs.timed(TB.bfp_decode_matmul, w_args, iters=30)
        print(json.dumps(row), flush=True)
        del k5_args, w_args
    if args.ptxas:
        _ptxas(build)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
