"""End-to-end QAT-style training driver of the PyTorch port with HiF4 A-W
fake quant + STE and fault-tolerant checkpointing.

    PYTHONPATH=src python examples/torch_train_quantized_lm.py [--steps 200]
    PYTHONPATH=src python examples/torch_train_quantized_lm.py --device cpu

The counterpart of ``examples/train_quantized_lm.py`` on ``repro_torch``
alone, with the same line per run. Two runs on the reduced config, ``none``
and ``--quant``, each checkpointing every 50 steps into ``<ckpt>_<fmt>``
(``repro_torch.checkpoint``, the reference's bytes); a directory that
already holds a run resumes from its newest checkpoint, and one that holds
a finished run has nothing left to train. Like ``python -m repro_torch
train``, it trains on one device: data parallelism has one rank, so the
HiF4-compressed gradient all-reduce (``repro_torch.optim.grad_compress``)
runs at world size 1 and nothing goes on the wire. Impl qdq: fake
quantization in plain PyTorch, no kernel of the port, as in the reference.

(The paper's conclusion flags HiF4 training as future work; this driver
demonstrates the framework side: the 69-binade range casts gradients
directly, no per-tensor scale sweep.)
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.core.qlinear import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelCtx
from repro_torch.runtime import TrainLoopConfig, train

CHECKPOINT_EVERY = 50


def run_line(fmt: str, hist: dict, steps: int) -> str:
    """The line printed for one run."""
    if not hist["loss"]:
        return f"{fmt:6}: nothing to train, the checkpoint is at step {steps}"
    return (f"{fmt:6}: loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
            f"(mean step {1e3 * sum(hist['step_time']) / len(hist['step_time']):.0f}ms, "
            f"stragglers: {len(hist['stragglers'])})")


def train_run(cfg, fmt: str, steps: int, ckpt: str, device) -> dict:
    """One run under ``fmt``, checkpointed into ``<ckpt>_<fmt>``: its
    history {"loss", "step_time", "stragglers"}."""
    ctx = ModelCtx(quant=QuantConfig(fmt=fmt), remat=False,
                   attn_q_chunk=32, attn_k_chunk=32)
    _, _, hist = train(cfg, ctx, TrainLoopConfig(
        steps=steps, global_batch=8, seq_len=64,
        checkpoint_dir=ckpt + "_" + fmt,
        checkpoint_every=CHECKPOINT_EVERY), device=device)
    return hist


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train a reduced LM unquantized "
                                             "and with HiF4 fake quant")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--quant", default="hif4")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where it runs (cuda, or cpu when asked)")
    args = ap.parse_args(argv)
    # before cuBLAS first initializes: the loop runs deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "hif4_train_ckpt")
    for fmt in ("none", args.quant):
        hist = train_run(cfg, fmt, args.steps, ckpt, device)
        print(run_line(fmt, hist, args.steps), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
