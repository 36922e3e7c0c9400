"""The card's constants, and the reference's production mesh shapes (the
counterpart of ``repro/launch/mesh.py``).

The port runs on one NVIDIA H100 SXM 80 GB. Its published figures
(NVIDIA's H100 datasheet, dense, no sparsity: 989 TFLOP/s bf16, 1 979 TOP/s
int8, 3.35 TB/s HBM, 80 GB) set the dry run's roofline terms, which cost
bf16 operations only, so the int8 rate has no constant here. No TPU constant
is carried over: the reference's v5e figures describe another chip and are
not ported.

The reference's meshes appear here as axis sizes only, with no devices
behind them: the dry run uses them for residency accounting under
:class:`repro_torch.sharding.rules.ShardCtx`, nothing else.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80e9              # bytes of device memory

# the one card: every logical axis resolves to a mesh axis of size 1
CARD_MESH = {"data": 1, "model": 1}
# the reference's production meshes: one pod, and two pods
SINGLE_POD_MESH = {"data": 16, "model": 16}
MULTI_POD_MESH = {"pod": 2, "data": 16, "model": 16}

MESHES = {"card": CARD_MESH, "16x16": SINGLE_POD_MESH,
          "2x16x16": MULTI_POD_MESH}


def mesh_devices(mesh: dict) -> int:
    n = 1
    for size in mesh.values():
        n *= size
    return n
