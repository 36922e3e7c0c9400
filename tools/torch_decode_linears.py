#!/usr/bin/env python3
"""Time the port's decode linears on a CUDA card, for one source tree.

    python3 tools/torch_decode_linears.py [--src SRC] [--label NAME]

Each quantized linear of qwen1.5-0.5b's decode step, at batch 8, as the
engine runs it (``repro_torch.core.engine.matmul`` on a packed HiF4 weight
under impl packed, bf16 in and out): wq/wk/wv/wo (K=1024, N=1024), wg/wu
(K=1024, N=2816) and the MLP's wo (K=2816, N=1024), plus M=32 at
K=2816, N=1024. ``--src`` names the ``src`` directory whose ``repro_torch``
is imported (default: this checkout's), so one call on the card can time
two trees in turns. Per shape it prints one JSON line with the launches of
one call (by kernel), ``kernel_ms`` (CUDA events around the eager loop),
``device_ms`` (the same calls captured in a CUDA graph and replayed) and
``host_us`` (host clock per call, no synchronize in the window), over
weights rotated through more than the 50 MB L2, and the same three for
kernel 1 then kernel 2 called directly (``pair``: no cast, no engine);
then the card's name and power limit. The timing helpers are
``chip_smoke.py``'s.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((8, 1024, 1024), (8, 1024, 2816), (8, 2816, 1024), (32, 2816, 1024))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
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
    from repro_torch.kernels.fused_matmul import fused_packed_matmul
    from repro_torch.kernels.hif4_quant import hif4_quantize

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    ectx = engine.EngineCtx(QuantConfig(fmt="hif4", impl="packed"))
    gen = torch.Generator(device=dev).manual_seed(0)

    def linear(x, pw):
        return engine.matmul(x, pw, ectx)

    def pair(x, pw):
        return fused_packed_matmul(*hif4_quantize(x), pw.codes, pw.meta)

    for m, k, n in SHAPES:
        rot = -(-60 * 2 ** 20 // (k * n * 9 // 16))     # > the 50 MB L2
        pws = [PackedW.from_dense((torch.randn(k, n, generator=gen, device=dev)
                                   * 0.02).to(torch.bfloat16)).to_kernel_layout()
               for _ in range(rot)]
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        args_list = [(x, pw) for pw in pws]
        linear(*args_list[0])
        torch.cuda.synchronize()
        build.reset_launches()
        linear(*args_list[0])
        torch.cuda.synchronize()
        launches = {key: v for key, v in build.LAUNCHES.items() if v}
        t = cs.timed(linear, args_list)
        print(json.dumps({"tree": args.label or args.src, "shape": [m, k, n],
                          "launches_per_call": launches, **t,
                          "pair": cs.timed(pair, args_list)}), flush=True)
        del pws, args_list
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
