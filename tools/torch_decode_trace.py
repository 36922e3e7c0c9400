#!/usr/bin/env python3
"""Where a launch of the decode form of kernel 2 spends its time, by phase.

    python3 tools/torch_decode_trace.py        # on a CUDA card

Builds ``src/repro_torch/csrc/fused_decode_matmul.cu`` with
``-DREPRO_DECODE_TRACE`` (thread 0 of each CTA records the global timer,
after a block barrier, at each phase boundary), launches it 20 times at each
of qwen1.5-0.5b's decode shapes at M=8 and at M=32, K=2816, N=1024, on
weights rotated through more than the 50 MB L2, and prints per phase the
median over launches of the median and the latest CTA, in microseconds
since the first CTA of the launch started: loads issued, prologue (the
activations quantized), expand and dot (the weight's copies waited for,
expanded and dotted), the cluster barrier, the sums written. The barriers
add a little time of their own, so the phases are shares of a slightly
slower launch than the untraced one.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((8, 1024, 1024), (8, 1024, 2816), (8, 2816, 1024), (32, 2816, 1024))
PHASES = ("loads issued", "prologue", "expand and dot", "cluster barrier",
          "sums written")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.qlinear import PackedW
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_matmul import decode_plan

    csrc = build.CSRC
    lib_path = Path(tempfile.mkdtemp()) / "fused_decode_trace.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DREPRO_DECODE_TRACE",
                    "-I", str(csrc), "-o", str(lib_path),
                    str(csrc / "fused_decode_matmul.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = lib.fused_decode_matmul
    launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in SHAPES:
        rot = -(-60 * 2 ** 20 // (k * n * 9 // 16))
        pws = [PackedW.from_dense((torch.randn(k, n, generator=gen, device=dev)
                                   * 0.02).to(torch.bfloat16)).to_kernel_layout()
               for _ in range(rot)]
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        plan = decode_plan(m, k, n)
        stamps = []
        for it in range(25):
            pw = pws[it % rot]
            rc = launch(x.data_ptr(), pw.codes.data_ptr(), pw.meta.data_ptr(),
                        out.data_ptr(), m, n, k, plan.split, plan.smem_bytes, 1,
                        1, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            if it >= 5:                                   # warm launches
                buf = np.zeros(plan.grid * 8, np.uint64)
                if lib.repro_decode_trace_read(buf.ctypes.data_as(p),
                                               plan.grid * 8):
                    raise RuntimeError("reading the trace failed")
                stamps.append(buf.reshape(plan.grid, 8)[:, :6].astype(np.int64))
        t = np.stack(stamps)                              # (launches, CTAs, 6)
        t = (t - t[:, :, :1].min(axis=1, keepdims=True)) / 1e3
        print(f"M={m} K={k} N={n}: {plan.grid} CTAs in clusters of "
              f"{plan.split}; us since the first CTA started (median over "
              f"launches of the CTAs' median / latest):")
        for j, name in enumerate(PHASES, start=1):
            med = float(np.median(np.median(t[:, :, j], axis=1)))
            last = float(np.median(t[:, :, j].max(axis=1)))
            print(f"  {name:16s} {med:8.2f} / {last:8.2f}")
        del pws
    return 0


if __name__ == "__main__":
    sys.exit(main())
