"""Training launcher of the PyTorch port (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 16 [--ckpt-dir ckpt]                                # on cuda
    PYTHONPATH=src python -m repro_torch train --arch qwen1.5-0.5b --reduced \\
        --device cpu --steps 10 --global-batch 4 --seq-len 32
    PYTHONPATH=src python -m repro_torch train --arch mamba2-1.3b \
        --layers 12 --steps 4                                 # a depth cut

Trains on the synthetic affine stream (``repro_torch.data``) with AdamW
from random weights made from ``--seed`` (drawn on the card on cuda), with
``--quant``'s fake quantization on every linear site of the default policy
(impl qdq: no kernel of the port runs, as in the reference). Layer remat is
on unless ``--reduced``; the attention chunks are min(512, S) queries and
min(1024, S) keys. ``--layers N`` trains the first N layers of the config
(a depth cut for time, at full width: the decoder's layers, or the hybrid's
Mamba layers, its shared block called every ``hybrid_attn_every`` of
them). With ``--ckpt-dir`` the run resumes from the newest
checkpoint there and saves every 25 steps and at the end. Prints a loss
line every ``--log-every`` steps, the final loss, and the median step
time, tokens per second and (on cuda) the peak of
``torch.cuda.max_memory_allocated``.
"""
import argparse
import dataclasses
import os
import statistics
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="train-loop entry")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--quant", default="hif4")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="train the first N layers only (a depth cut)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where training runs (cuda, or cpu when asked)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # before cuBLAS first initializes: the loop runs deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.qlinear import QuantConfig
    from repro_torch.device import resolve_device
    from repro_torch.models.common import ModelCtx
    from repro_torch.runtime.train_loop import TrainLoopConfig, train

    device = resolve_device(args.device)
    try:
        cfg = get_arch(args.arch)
    except ValueError as e:                     # an unknown arch
        print(e, file=sys.stderr)
        return 2
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.n_layers:
            print(f"--layers {args.layers}: {cfg.name} has {cfg.n_layers}",
                  file=sys.stderr)
            return 2
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    ctx = ModelCtx(quant=QuantConfig(fmt=args.quant), remat=not args.reduced,
                   attn_q_chunk=min(512, args.seq_len),
                   attn_k_chunk=min(1024, args.seq_len))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def on_step(s, st):
        if s % args.log_every == 0:
            print(f"step {s:5d} loss {st['loss']:.4f} ({st['time'] * 1e3:.1f} ms)",
                  flush=True)

    _, _, hist = train(cfg, ctx, TrainLoopConfig(
        steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, checkpoint_dir=args.ckpt_dir,
        num_microbatches=args.microbatches, seed=args.seed),
        on_step=on_step, device=device,
        draw_on_device=device.type == "cuda")
    if not hist["loss"]:
        print(f"nothing to run: the checkpoint is at step {args.steps}")
        return 0
    print(f"final loss: {hist['loss'][-1]:.4f}; "
          f"stragglers flagged: {len(hist['stragglers'])}")
    med = statistics.median(hist["step_time"])
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"
            if device.type == "cuda" else "n/a (cpu)")
    print(f"median step {med * 1e3:.2f} ms, "
          f"{args.global_batch * args.seq_len / med:.0f} tokens/s, "
          f"peak memory {peak}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
