"""Kernel 5: group-scaled int8 x int8 matmul on pre-quantized HiF4 operands
(paper §III.B: the micro-exponents are left shifts, so a 64-length dot is
integer work with one float multiply per group).

Port of the TPU Pallas kernel ``repro/kernels/bfp_matmul.py::
bfp_matmul_quantized`` as the CUDA kernel ``csrc/bfp_matmul.cu``:

  a_ints (M, K) int8, a_scales (M, K/64) f32,
  b_ints (K, N) int8, b_scales (K/64, N) f32 -> (M, N) f32
      = sum over 64-groups g of float(int32 dot_g) * a_scale * b_scale

Two CUDA bodies: ``csrc/group_matmul_decode.cuh`` for at most
``DECODE_M_MAX`` rows (a persistent grid whose warps stream whole columns
once through per-warp ``cp.async`` rings, the activation words in
registers; launch plan :func:`decode_matmul_plan`) and ``csrc/group_matmul_sm90.cuh`` above (int8
``wgmma``, a warp-specialized ring of one-group stages, shared with kernel
2, so kernel 5 on the absorbed expansion of a packed weight is bitwise
kernel 2 on it; launch plan :func:`prefill_plan`). The kernel reads B
K-contiguous per column: a transposed view of a contiguous (N, K) tensor
(what the engine passes: ``hif4_quantize(w.T)`` transposed back) launches
on its storage without a copy; a row-major (K, N) operand is copied once
into that layout.

The decode form of kernel 5, :func:`bfp_decode_matmul` (CUDA kernel
``csrc/bfp_decode_matmul.cu``, the same decode body with a loader that runs
kernel 1's Algorithm 1 on the weight):

  a_ints (M, K) int8, a_scales (M, K/64) f32, w (K, N) bf16/f32 -> (M, N) f32

bit for bit kernel 1 on ``w.T`` followed by kernel 5
(:func:`bfp_decode_matmul_plain`, its plain version), in one launch that
reads the weight once and writes no quantized copy of it. The tied LM head
hands over ``embed.T``, whose storage is K-contiguous per column.

:func:`bfp_matmul_quantized_plain` is the plain PyTorch version (the
reference's ``_tile_group_dot``: exact int32 group dots, then the f32
rescale), summed in group order with the kernels' rounding steps, so kernel
and plain version agree bitwise; the wrappers take the plain versions only
for CPU tensors. The plain version of kernel 2 is this one on the expanded
weight. :func:`select_block_sizes` keeps the reference's per-regime tiles for
the dispatch report; :func:`cuda_tiles` names the CUDA kernels' tiles.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hif4_quant import absorbed_activation

GROUP = 64
# Decode M (a batch of single-token rows) vs prefill M regime boundary.
DECODE_M_MAX = 32
H100_SMS = 132


def _fit(dim: int, want: int, quantum: int) -> int:
    """Largest block <= want that divides dim and is a multiple of quantum."""
    b = (want // quantum) * quantum
    while b > quantum and dim % b != 0:
        b -= quantum
    b = max(b, quantum)
    if dim % b:
        raise ValueError(f"no block for dim={dim} (want {want}, quantum {quantum})")
    return b


def select_block_sizes(M: int, N: int, K: int) -> tuple[int, int, int]:
    """The reference's (bm, bn, bk) per regime: decode takes all of M with
    deep-K / wide-N tiles, prefill square-ish 256/256/512 tiles."""
    if M <= DECODE_M_MAX:
        return M, _fit(N, min(512, N), 1), _fit(K, min(1024, K), GROUP)
    return (_fit(M, min(256, M), 1), _fit(N, min(256, N), 1),
            _fit(K, min(512, K), GROUP))


# The prefill body (csrc/group_matmul_sm90.cuh, M > DECODE_M_MAX): one CTA
# of 384 threads per PREFILL_TILE_M x PREFILL_TILE_N output tile, a ring of
# PREFILL_STAGES stages of one 64-group each, PREFILL_LOOKAHEAD groups of
# copies in flight. Mirrored from the C++ constants; the launcher refuses a
# plan that differs from its own in any field.
PREFILL_TILE_M = 128
PREFILL_TILE_N = 128
PREFILL_STAGES = 6
PREFILL_LOOKAHEAD = 4
SMEM_PER_CTA_MAX = 232_448          # 227 KB of dynamic shared memory per CTA
# a stage's raw bytes per loader: kernel 2's 32 code rows of the tile's
# columns and their meta words; kernel 5's columns go straight to the tile
_RAW_BYTES = {"packed": 32 * PREFILL_TILE_N + 4 * PREFILL_TILE_N, "int8": 0}


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """The launch of the prefill body: ``tile_m`` x ``tile_n`` output tiles,
    a ring of ``stages`` stages of ``stage_bytes`` (A and B tiles of 64
    bytes a row, their scales, the loader's raw bytes) with ``lookahead``
    groups of copies in flight, ``smem_bytes`` of dynamic shared memory in
    all. The launcher takes every field (:meth:`c_plan`) and refuses a plan
    that differs from its constants."""

    tile_m: int
    tile_n: int
    stages: int
    lookahead: int
    stage_bytes: int
    smem_bytes: int

    def c_plan(self):
        """The fields as the launcher's ``const int* plan``, in its order."""
        fields = dataclasses.astuple(self)
        return (ctypes.c_int * len(fields))(*fields)


def _round(nbytes: int, quantum: int) -> int:
    return -(-nbytes // quantum) * quantum


def prefill_plan(m: int, k: int, n: int, loader: str = "packed") -> PrefillPlan:
    """csrc/group_matmul_sm90.cuh's carve-up for ``loader`` ("packed": kernel
    2, "int8": kernel 5): stages 1024-byte aligned (the 64-byte swizzle
    repeats every 512 B and keys on address bits), 1024 B to align the
    dynamic base, 16 B of mbarriers per stage."""
    if m <= DECODE_M_MAX or k < GROUP or k % GROUP or n < 1:
        raise ValueError(f"the prefill body takes M > {DECODE_M_MAX}, K % 64 "
                         f"== 0 and N >= 1, got (M, K, N) = {(m, k, n)}")
    tm, tn = PREFILL_TILE_M, PREFILL_TILE_N
    stage = _round(tm * GROUP + tn * GROUP + 4 * tm + 4 * tn
                   + _RAW_BYTES[loader], 1024)
    smem = 1024 + PREFILL_STAGES * stage + _round(2 * PREFILL_STAGES * 8, 128)
    if smem > SMEM_PER_CTA_MAX:
        raise ValueError(f"the prefill plan needs {smem} B of shared memory")
    return PrefillPlan(tm, tn, PREFILL_STAGES, PREFILL_LOOKAHEAD, stage, smem)


# The decode body (csrc/group_matmul_decode.cuh, M <= DECODE_M_MAX): a
# persistent grid of CTAs of DECODE_WARPS warps; a warp walks whole columns
# in chunks of DECODE_CHUNK elements (lane l: ints 32 l .. 32 l + 31)
# through its own ring of stages in shared memory, with a quantizing
# loader's staging row and the term tile (16 groups + 4 floats per row
# slot) beside it. Mirrored from the C++ constants; the launcher refuses a
# plan that differs from its own.
DECODE_WARPS = 8
DECODE_CHUNK = 1024
_DECODE_TERM_STRIDE = 20
SMEM_PER_SM = 233_472               # 228 KB, 1 KB of it reserved per CTA
# per loader: (bytes of a stage, ring stages, staging bytes, most CTAs per SM)
_DECODE_LOADERS = {"int8": (DECODE_CHUNK + 64, 5, 0, 2),
                   "bf16": (2 * DECODE_CHUNK, 3, DECODE_CHUNK + 64, 2),
                   "f32": (4 * DECODE_CHUNK, 3, DECODE_CHUNK + 64, 2)}


@dataclasses.dataclass(frozen=True)
class DecodeMatmulPlan:
    """The launch of the decode body: ``rows`` row slots (M rounded up to
    8), a ring of ``stages`` chunks per warp, ``warps`` warps per CTA,
    ``ctas_per_sm`` CTAs per SM, ``grid`` CTAs, ``smem_bytes`` of shared
    memory per CTA (the warps' rings, staging rows and term tiles). The
    launcher takes every field (:meth:`c_plan`) and refuses a plan that
    differs from its constants."""

    rows: int
    stages: int
    warps: int
    ctas_per_sm: int
    grid: int
    smem_bytes: int

    def c_plan(self):
        """The fields as the launcher's ``const int* plan``, in its order."""
        fields = dataclasses.astuple(self)
        return (ctypes.c_int * len(fields))(*fields)


def decode_matmul_plan(m: int, k: int, n: int, loader: str = "int8"
                       ) -> DecodeMatmulPlan:
    """csrc/group_matmul_decode.cuh's launch for ``loader`` ("int8": kernel
    5, "bf16" / "f32": its decode form quantizing such a weight): a warp per
    column at a time; the loader's CTAs per SM, or as many as the SM's
    shared memory holds; the grid covers every column once or fills the
    H100, whichever is fewer CTAs."""
    if not 1 <= m <= DECODE_M_MAX or k < GROUP or k % GROUP or n < 1:
        raise ValueError(f"the decode body takes 1 <= M <= {DECODE_M_MAX}, "
                         f"K % 64 == 0 and N >= 1, got (M, K, N) = {(m, k, n)}")
    stage, stages, staging, most = _DECODE_LOADERS[loader]
    rows = -(-m // 8) * 8
    smem = DECODE_WARPS * (stages * stage + staging
                           + rows * _DECODE_TERM_STRIDE * 4)
    ctas = min(most, SMEM_PER_SM // (smem + 1024))
    grid = min(-(-n // DECODE_WARPS), H100_SMS * ctas)
    return DecodeMatmulPlan(rows, stages, DECODE_WARPS, ctas, grid, smem)


def cuda_tiles(M: int) -> tuple[int, int, int]:
    """Kernel 2's tiles for this M: (BM, BN, 64-groups staged per step) of
    its ``__dp4a`` body (``csrc/group_matmul.cuh``) up to ``DECODE_M_MAX``
    rows, (BM, BN, ring stages of one 64-group) of the tensor-core body
    above (kernel 5's too; its decode tiles are :func:`decode_matmul_plan`'s)."""
    if M <= 16:
        return 16, 32, 4
    if M <= DECODE_M_MAX:
        return 32, 32, 4
    return PREFILL_TILE_M, PREFILL_TILE_N, PREFILL_STAGES


def _group_dot(a_ints: torch.Tensor, b_ints: torch.Tensor, g: int
               ) -> torch.Tensor:
    """(M, N) float32 holding the exact int32 dot of 64-group ``g``: a
    float32 GEMM of integers (|product| <= 784, sums < 2^24: exact in any
    order)."""
    k = slice(g * GROUP, (g + 1) * GROUP)
    return a_ints[:, k].to(torch.float32) @ b_ints[k].to(torch.float32)


def group_partials(a_ints: torch.Tensor, b_ints: torch.Tensor) -> torch.Tensor:
    """(K/64, M, N) int32: the exact integer dot of every 64-group."""
    return torch.stack([_group_dot(a_ints, b_ints, g).to(torch.int32)
                        for g in range(a_ints.shape[1] // GROUP)])


def bfp_matmul_quantized_plain(a_ints, a_scales, b_ints, b_scales):
    """Plain version: ``acc += (dot_g * a_scale) * b_scale`` over the groups
    in order, each product and sum rounded to float32 (the kernel's
    ``__fmul_rn`` / ``__fadd_rn``)."""
    M, K = a_ints.shape
    acc = torch.zeros((M, b_ints.shape[1]), dtype=torch.float32,
                      device=a_ints.device)
    for g in range(K // GROUP):
        part = _group_dot(a_ints, b_ints, g)
        acc = acc + (part * a_scales[:, g, None]) * b_scales[None, g, :]
    return acc


def _check(a_ints, a_scales, b_ints, b_scales):
    if a_ints.ndim != 2 or b_ints.ndim != 2:
        raise ValueError("bfp_matmul_quantized takes 2-D operands")
    M, K = a_ints.shape
    K2, N = b_ints.shape
    if K2 != K or K % GROUP:
        raise ValueError(f"a_ints {tuple(a_ints.shape)} does not match b_ints "
                         f"{tuple(b_ints.shape)} (K % 64 == 0 required)")
    if tuple(a_scales.shape) != (M, K // GROUP) or \
            tuple(b_scales.shape) != (K // GROUP, N):
        raise ValueError(f"scales {tuple(a_scales.shape)} / "
                         f"{tuple(b_scales.shape)} do not match (M, K, N) = "
                         f"{(M, K, N)}")
    want = {"a_ints": (a_ints, torch.int8), "a_scales": (a_scales, torch.float32),
            "b_ints": (b_ints, torch.int8), "b_scales": (b_scales, torch.float32)}
    for name, (t, dt) in want.items():
        if t.dtype != dt:
            raise TypeError(f"bfp_matmul_quantized: {name} must be {dt}, got {t.dtype}")
    devices = {t.device for t in (a_ints, a_scales, b_ints, b_scales)}
    if len(devices) != 1:
        raise ValueError(f"bfp_matmul_quantized: operands on {devices}")
    return M, K, N


def _k_contiguous(t: torch.Tensor, name: str) -> torch.Tensor:
    """A (K, N) operand as (N, K) storage, K contiguous per column: a
    transposed view of a contiguous tensor as it is, a row-major one copied."""
    if t.T.is_contiguous():
        return t.T
    if t.is_contiguous():
        return t.T.contiguous()
    raise ValueError(f"bfp_matmul_quantized: {name} must be row-major or the "
                     f"transpose of a contiguous tensor, got strides {t.stride()}")


def bfp_matmul_quantized(a_ints, a_scales, b_ints, b_scales) -> torch.Tensor:
    """(M, N) f32: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    M, K, N = _check(a_ints, a_scales, b_ints, b_scales)
    dev = a_ints.device
    if dev.type == "cpu":
        return bfp_matmul_quantized_plain(a_ints, a_scales, b_ints, b_scales)
    if dev.type != "cuda":
        raise ValueError(f"bfp_matmul_quantized: unsupported device {dev}")
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"bfp_matmul_quantized: no work for (M, K, N) = "
                         f"{(M, K, N)}")
    if not (a_ints.is_contiguous() and a_scales.is_contiguous()):
        raise ValueError("bfp_matmul_quantized needs contiguous a_ints, a_scales")
    b_nk = _k_contiguous(b_ints, "b_ints")
    bs_nk = _k_contiguous(b_scales, "b_scales")
    regime = 0 if M <= DECODE_M_MAX else 1
    if a_ints.data_ptr() % 16 or b_nk.data_ptr() % 16:   # 16-byte pieces
        raise ValueError("bfp_matmul_quantized: int8 operands must be "
                         "16-byte aligned")
    plan = (prefill_plan(M, K, N, "int8") if regime
            else decode_matmul_plan(M, K, N, "int8")).c_plan()
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("bfp_matmul", "bfp_matmul_quantized",
                        [p, p, p, p, p, i, i, i, i, ctypes.POINTER(i), p])
    rc = fn(a_ints.data_ptr(), a_scales.data_ptr(), b_nk.data_ptr(),
            bs_nk.data_ptr(), out.data_ptr(), M, N, K, regime, plan,
            build.stream_ptr(dev))
    build.check("bfp_matmul", "bfp_matmul_quantized", rc, (M, K, N))
    return out


# ---------------------------------------------------------------------------
# the decode form: the weight's Algorithm 1 folded into the loader
# ---------------------------------------------------------------------------

_FLOATS = (torch.bfloat16, torch.float32)


def bfp_decode_matmul_plain(a_ints, a_scales, w):
    """Plain version: kernel 1's plain version on ``w.T`` (each column's
    64-groups along K), then kernel 5's."""
    wi, wsc = absorbed_activation(w.T)
    return bfp_matmul_quantized_plain(a_ints, a_scales, wi.T, wsc.T)


def bfp_decode_matmul(a_ints, a_scales, w) -> torch.Tensor:
    """(M, N) f32 for at most ``DECODE_M_MAX`` rows: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. ``w`` (K, N) bf16/f32 is read
    K-contiguous per column: a transposed view of a contiguous (N, K) tensor
    (the tied embedding's ``embed.T``) as it is, a row-major one copied.
    Counted as a launch of ``bfp_matmul_quantized`` (kernel 5 in either
    form) and of ``bfp_decode_matmul``."""
    if a_ints.ndim != 2 or w.ndim != 2:
        raise ValueError("bfp_decode_matmul takes 2-D operands")
    M, K = a_ints.shape
    K2, N = w.shape
    if K2 != K or K % GROUP or tuple(a_scales.shape) != (M, K // GROUP):
        raise ValueError(f"a_ints {tuple(a_ints.shape)} / a_scales "
                         f"{tuple(a_scales.shape)} do not match w "
                         f"{tuple(w.shape)} (K % 64 == 0 required)")
    if a_ints.dtype != torch.int8 or a_scales.dtype != torch.float32:
        raise TypeError(f"bfp_decode_matmul: a_ints must be int8 and a_scales "
                        f"float32, got {a_ints.dtype}, {a_scales.dtype}")
    if w.dtype not in _FLOATS:
        raise TypeError(f"bfp_decode_matmul quantizes bf16/f32, not {w.dtype}")
    if not a_ints.device == a_scales.device == w.device:
        raise ValueError(f"bfp_decode_matmul: operands on {a_ints.device}, "
                         f"{a_scales.device}, {w.device}")
    dev = a_ints.device
    if dev.type == "cpu":
        return bfp_decode_matmul_plain(a_ints, a_scales, w)
    if dev.type != "cuda":
        raise ValueError(f"bfp_decode_matmul: unsupported device {dev}")
    if M == 0 or N == 0 or M > DECODE_M_MAX:
        raise ValueError(f"bfp_decode_matmul takes 1 <= M <= {DECODE_M_MAX} "
                         f"and N >= 1, got (M, K, N) = {(M, K, N)}")
    if not (a_ints.is_contiguous() and a_scales.is_contiguous()):
        raise ValueError("bfp_decode_matmul needs contiguous a_ints, a_scales")
    w_nk = _k_contiguous(w, "w")
    if a_ints.data_ptr() % 16 or w_nk.data_ptr() % 16:
        raise ValueError("bfp_decode_matmul: a_ints and w must be 16-byte "
                         "aligned")
    bf16 = w.dtype == torch.bfloat16
    plan = decode_matmul_plan(M, K, N, "bf16" if bf16 else "f32").c_plan()
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("bfp_decode_matmul", "bfp_decode_matmul",
                        [p, p, p, p, i, i, i, ctypes.POINTER(i), i, p])
    rc = fn(a_ints.data_ptr(), a_scales.data_ptr(), w_nk.data_ptr(),
            out.data_ptr(), M, N, K, plan, int(bf16), build.stream_ptr(dev))
    build.check("bfp_decode_matmul", "bfp_decode_matmul", rc, (M, K, N))
    build.count_launch("bfp_matmul_quantized")
    return out
