#!/usr/bin/env python3
"""Time the decode-attention kernels (3 and 4) on a CUDA card, for one
source tree, and trace where a launch spends its time.

    python3 tools/torch_decode_attention.py [--src SRC] [--label NAME] [--no-trace]

Cases, at qwen1.5-0.5b's widths (Hkv=16, D=64, batch 8, HiF4 KV), the ones
``chip_smoke.py`` times:

- ``k3 S=512``: ``fused_decode_attention`` on a full 512-token cache (the
  serve phase's shape, KV tiles of 256);
- ``k3 S=512 block_kv=64 ragged``: the same kernel at ``block_kv = 64`` (a
  solo serve's tiling), capacity 512, the ragged lengths below;
- ``k4 P=64 pages=8``: ``fused_paged_decode_attention`` on 8 full pages per
  slot (the paged phase's shape);
- ``k4 P=64 pages=8 ragged``: the paged phase's ragged table
  (``chip_smoke.RAGGED_TABLE``): a shared prefix, partial last pages,
  trailing scratch entries, a 33-token slot.

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so one call on the card can time two trees in
turns. Per case it prints one JSON line: ``kernel_ms`` (CUDA events around
the eager loop), ``device_ms`` (the same calls captured in a CUDA graph and
replayed), ``host_us`` (host clock per call), over inputs rotated through
more than the 50 MB L2, and ``bound_ms`` (the bytes this case's data needs
over 3.35 TB/s). The timing helpers are ``chip_smoke.py``'s.

With the trace (the default), ``fused_attention.cu`` of the same tree is
built again with ``-DREPRO_ATTN_TRACE`` and put in place of the plain
library, each case is launched 20 times, and the per-CTA phase totals
(thread 0 reads the global timer after a block barrier at each phase
boundary) are printed as the median over launches of the CTAs' median, in
microseconds, with the CTAs' end since the first CTA started (median /
latest). The barriers add a little time of their own. A tree whose source
has no trace points prints none.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("setup", "loads issued", "K/V staged", "scores", "softmax", "p.V",
          "ordered sum")
B, HKV, D, P, MAXP = 8, 16, 64, 64, 8


def cases(dev, gen):
    """(name, wrapper, args per L2 rotation, bound_ms) for each case."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.fused_attention import (
        fused_decode_attention, fused_paged_decode_attention)

    q = (torch.randn(B, HKV, D, generator=gen) * 0.5).to(torch.bfloat16).to(dev)
    full = torch.full((B,), MAXP * P, dtype=torch.int32, device=dev)
    ragged = torch.tensor(cs.RAGGED_LENGTH, dtype=torch.int32, device=dev)
    caches = [cs._packed_cache(B, MAXP * P, HKV, D, gen, dev)
              for _ in range(cs.L2_ROTATION)]
    n_pages = 1 + B * MAXP
    arange = torch.arange(1, n_pages, dtype=torch.int32, device=dev).reshape(B, MAXP)
    table = torch.tensor(cs.RAGGED_TABLE, dtype=torch.int32, device=dev)
    pools = [(cs._paged_pool(n_pages, P, HKV, D, gen, dev),
              cs._paged_pool(n_pages, P, HKV, D, gen, dev))
             for _ in range(cs.L2_ROTATION)]

    def k3(block_kv=None):
        return lambda *a: fused_decode_attention(*a, n_kv_heads=HKV, d_head=D,
                                                 block_kv=block_kv)

    def k4(*a):
        return fused_paged_decode_attention(*a, n_kv_heads=HKV, d_head=D)

    b3 = cs.attention_bound_ms(HKV, D, full, None, MAXP * P)
    b3r = cs.attention_bound_ms(HKV, D, ragged, None, MAXP * P)
    b4 = cs.attention_bound_ms(HKV, D, full, arange, P)
    b4r = cs.attention_bound_ms(HKV, D, ragged, table, P)
    return [
        ("k3 S=512", k3(), [(q, pk, pv, full) for pk, pv in caches], b3),
        ("k3 S=512 block_kv=64 ragged", k3(P),
         [(q, pk, pv, ragged) for pk, pv in caches], b3r),
        ("k4 P=64 pages=8", k4, [(q, kp, vp, arange, full) for kp, vp in pools], b4),
        ("k4 P=64 pages=8 ragged", k4,
         [(q, kp, vp, table, ragged) for kp, vp in pools], b4r),
    ]


def trace(src: Path, all_cases, label: str) -> None:
    """Build the traced library of ``src`` and print each case's phases."""
    import numpy as np
    import torch
    from repro_torch.kernels import build

    cu = src / "repro_torch" / "csrc" / "fused_attention.cu"
    if "REPRO_ATTN_TRACE" not in cu.read_text():
        print(f"{label}: no trace points in {cu}")
        return
    lib_path = Path(tempfile.mkdtemp()) / "fused_attention_trace.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DREPRO_ATTN_TRACE", "-I",
                    str(cu.parent), "-o", str(lib_path), str(cu)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    slots = lib.repro_attn_trace_slots()
    plain = build._LIBS.get("fused_attention")
    build._LIBS["fused_attention"] = lib
    try:
        ctas = HKV * B          # one CTA per (slot, head block) at D=64
        for name, fn, args_list, _ in all_cases:
            stamps = []
            for it in range(25):
                fn(*args_list[it % len(args_list)])
                torch.cuda.synchronize()
                if it >= 5:                              # warm launches
                    buf = np.zeros(ctas * slots, np.uint64)
                    if lib.repro_attn_trace_read(buf.ctypes.data_as(ctypes.c_void_p),
                                                 ctas):
                        raise RuntimeError("reading the trace failed")
                    stamps.append(buf.reshape(ctas, slots).astype(np.int64))
            t = np.stack(stamps)                         # (launches, CTAs, slots)
            totals = t[:, :, 1:slots - 1] / 1e3
            end = (t[:, :, slots - 1] - t[:, :, 0].min(axis=1, keepdims=True)) / 1e3
            phases = {ph: round(float(np.median(np.median(totals[:, :, j], axis=1))), 3)
                      for j, ph in enumerate(PHASES)}
            print(json.dumps({"tree": label, "trace": name, "ctas": ctas,
                              "phase_us_median_cta": phases,
                              "end_us": [round(float(np.median(np.median(end, axis=1))), 3),
                                         round(float(np.median(end.max(axis=1))), 3)]}),
                  flush=True)
    finally:
        if plain is None:
            build._LIBS.pop("fused_attention", None)
        else:
            build._LIBS["fused_attention"] = plain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--no-trace", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the times are the card's", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build

    label = args.label or args.src
    dev = torch.device("cuda", 0)
    build.build_all()
    gen = torch.Generator().manual_seed(0)
    all_cases = cases(dev, gen)
    for name, fn, args_list, bound_ms in all_cases:
        build.reset_launches()
        fn(*args_list[0])
        torch.cuda.synchronize()
        launches = {key: v for key, v in build.LAUNCHES.items() if v}
        t = cs.timed(fn, args_list, iters=100)
        print(json.dumps({"tree": label, "case": name, "launches_per_call": launches,
                          **t, "bound_ms": bound_ms}), flush=True)
    if not args.no_trace:
        trace(src, all_cases, label)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
