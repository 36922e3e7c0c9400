"""PTQ walkthrough of the PyTorch port: direct-cast vs HiGPTQ on a trained
layer (paper §IV-A).

    PYTHONPATH=src python examples/torch_ptq_higptq.py                # the card
    PYTHONPATH=src python examples/torch_ptq_higptq.py --device cpu   # the CPU

The counterpart of ``examples/ptq_higptq.py`` on ``repro_torch`` alone, with
the same lines. No kernel runs here, as in the reference: the direct cast
is Algorithm 1 and HiGPTQ is ``repro_torch.core.higptq``, plain PyTorch on
the device's tensors. Inputs come from ``torch.Generator``s seeded 0-2, as
the reference splits ``PRNGKey(0)`` in three; :func:`ptq_rows` takes them,
so the reference's own draws can be fed to it.
"""
import argparse

import torch

from repro_torch.core import hif4
from repro_torch.core.higptq import higptq_quantize, layer_output_error
from repro_torch.device import resolve_device

K, N, S = 512, 128, 1024


def draw_inputs() -> dict:
    """A "trained" weight w (K, N) with structure and calibration
    activations x (S, K) of rank K/8, f32 on the CPU."""
    def normal(seed, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                           dtype=torch.float32)

    w = normal(0, (K, N)) * 0.04
    base = normal(1, (S, K // 8))
    return {"w": w, "x": base @ (normal(2, (K // 8, K)) * 0.4)}


def direct_cast(w: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 along K, one 64-group per column slice, dequantized."""
    k, n = w.shape
    g = hif4.quantize_groups(w.T.reshape(n, k // 64, 64))
    return hif4.dequantize_groups(g).reshape(n, k).T


def ptq_rows(inputs: dict, device: torch.device) -> tuple[list, dict]:
    """(printed lines, values): ``direct`` and ``higptq`` are the layer
    output errors, ``wq_g`` the HiGPTQ weights on ``device``."""
    w, x = inputs["w"].to(device), inputs["x"].to(device)
    wq_d = direct_cast(w)
    wq_g = higptq_quantize(w, x)
    e_d = layer_output_error(w, wq_d, x)
    e_g = layer_output_error(w, wq_g, x)
    lines = ["layer output error ||X(W - Wq)|| / ||XW||",
             f"  HiF4 direct-cast : {e_d:.4f}",
             f"  HiF4 + HiGPTQ    : {e_g:.4f}  ({100 * (1 - e_g / e_d):.1f}% lower)"]
    return lines, {"direct": e_d, "higptq": e_g, "wq_g": wq_g}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where it runs (cuda, or cpu when asked)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines, _ = ptq_rows(draw_inputs(), device)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
