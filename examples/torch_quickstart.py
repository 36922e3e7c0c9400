"""Quickstart of the PyTorch port: the HiF4 format in five minutes.

    PYTHONPATH=src python examples/torch_quickstart.py                # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # the CPU

The counterpart of ``examples/quickstart.py`` on ``repro_torch`` alone,
printing the same sections with the same labels and number formats:

1. quantize a tensor with Algorithm 1 and inspect the unit structure
2. compare quantization error against NVFP4 / MXFP4 (paper Fig. 3)
3. run the fixed-point dot product (paper §III.B) — bit-exact vs dequant
4. run the HiF4 matmul kernels: on the card kernel 1 (``hif4_quantize``) on
   the activations, then, at M = 32 <= ``DECODE_M_MAX``, kernel 5's decode
   form (``bfp_decode_matmul``), which runs Algorithm 1 on the weight in its
   loader; on the CPU the kernels' plain PyTorch versions (bitwise the same)

Inputs come from ``torch.Generator``s seeded 0-5, one per draw, as the
reference folds 1-5 into ``PRNGKey(0)``. :func:`tour` takes the inputs, so
the reference's own draws can be fed to it.
"""
import argparse

import torch

from repro_torch.core import hif4
from repro_torch.core.formats import available_formats, get_format
from repro_torch.core.metrics import mse
from repro_torch.core.qlinear import hif4_dot_fixed_point
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.bfp_matmul import DECODE_M_MAX


def draw_inputs() -> dict:
    """The tour's inputs, f32 on the CPU: x (4, 64), big (1024, 1024),
    a and b (64,), m (32, 256) and w (256, 32), at the reference's scales."""
    def normal(seed, shape, scale):
        gen = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=gen, dtype=torch.float32) * scale

    return {"x": normal(0, (4, 64), 0.02), "big": normal(1, (1024, 1024), 0.01),
            "a": normal(2, (64,), 0.1), "b": normal(3, (64,), 0.1),
            "m": normal(4, (32, 256), 0.1), "w": normal(5, (256, 32), 0.05)}


def matmul_route(m: int) -> str:
    """What :func:`repro_torch.kernels.ops.matmul` launches for M rows."""
    if m <= DECODE_M_MAX:
        return "hif4_quantize, then bfp_decode_matmul"
    return "hif4_quantize on both operands, then bfp_matmul_quantized"


def tour(inputs: dict, device: torch.device) -> tuple[list, dict]:
    """The four sections on ``device``: (printed lines, values). The values
    hold the unrounded numbers (``e6m2``, ``mse`` by format, ``fixed_point``,
    ``dequant``, ``rel``) and the matmul's output ``y`` on ``device``."""
    t = {k: v.to(device) for k, v in inputs.items()}
    lines, values = [], {}

    # -- 1. one HiF4 unit ----------------------------------------------------
    g = hif4.quantize_groups(t["x"])
    values["e6m2"] = float(g.e6m2[0])
    lines += ["== HiF4 unit structure (first group) ==",
              f"  E6M2 level-1 scale : {values['e6m2']:.3e}",
              f"  E1_8 micro-exps    : {g.e1_8[0].tolist()}",
              f"  E1_16 micro-exps   : {g.e1_16[0].tolist()}",
              f"  S1P2 elements [:8] : {g.s1p2[0, :8].tolist()}",
              f"  storage            : {hif4.BITS_PER_VALUE} bits/value", ""]

    # -- 2. format comparison --------------------------------------------------
    big = t["big"]
    lines.append("== quantization MSE on N(0, 0.01^2) (paper Fig. 3 point x=0) ==")
    errs = {name: float(mse(big, get_format(name).qdq(big)))
            for name in available_formats()}
    values["mse"] = errs
    for name, e in sorted(errs.items(), key=lambda kv: kv[1]):
        lines.append(f"  {name:10} mse={e:.3e}  (x{e / errs['hif4']:.2f} vs hif4)")
    lines.append("")

    # -- 3. fixed-point dot product ---------------------------------------------
    a, b = t["a"], t["b"]
    fp = float(hif4_dot_fixed_point(a, b))
    ga, gb = hif4.quantize_groups(a[None]), hif4.quantize_groups(b[None])
    deq = float(torch.sum(hif4.dequantize_groups(ga) * hif4.dequantize_groups(gb)))
    values.update(fixed_point=fp, dequant=deq)
    lines += ["== 64-length dot: integer flow vs dequantized floats ==",
              f"  fixed-point: {fp:.6f}   dequant: {deq:.6f}   equal: {fp == deq}",
              ""]

    # -- 4. the matmul kernels ---------------------------------------------------
    m, w = t["m"], t["w"]
    y = ops.matmul(m, w)
    ref = m @ w
    rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
    values.update(y=y, rel=rel)
    where = ("the card's kernels" if device.type == "cuda"
             else "their plain PyTorch versions on the CPU")
    lines += [f"== HiF4 matmul: {matmul_route(m.shape[0])} ({where}) ==",
              f"  output {tuple(y.shape)}, relative error vs f32 matmul: {rel:.3%}"]
    return lines, values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where it runs (cuda, or cpu when asked)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines, _ = tour(draw_inputs(), device)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
