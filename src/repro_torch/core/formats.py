"""Format registry (port of ``repro/core/formats.py``).

``get_format(name)`` returns a :class:`BFPFormat` whose ``qdq(x, axis)`` maps
a tensor to its nearest representable tensor in that format (fake-quant):
HiF4 and the paper's baselines NVFP4, NVFP4+PTS and MXFP4. The packed and
kernel paths live in :mod:`repro_torch.core.hif4` / :mod:`repro_torch.kernels`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import hif4, mxfp4, nvfp4


@dataclasses.dataclass(frozen=True)
class BFPFormat:
    name: str
    group_size: int
    bits_per_value: float
    max_pos: float
    min_pos: float
    local_dynamic_range_binades: float
    qdq: Callable[..., torch.Tensor]          # (x, axis=-1) -> x_hat
    needs_pts: bool = False


_REGISTRY: dict[str, BFPFormat] = {}


def _register(fmt: BFPFormat) -> BFPFormat:
    _REGISTRY[fmt.name] = fmt
    return fmt


HIF4 = _register(
    BFPFormat(
        name="hif4",
        group_size=hif4.GROUP_SIZE,
        bits_per_value=hif4.BITS_PER_VALUE,
        max_pos=hif4.MAX_POS,
        min_pos=hif4.MIN_POS,
        local_dynamic_range_binades=4.81,   # log2(7 / 0.25)
        qdq=hif4.qdq,
    )
)

NVFP4 = _register(
    BFPFormat(
        name="nvfp4",
        group_size=nvfp4.GROUP_SIZE,
        bits_per_value=nvfp4.BITS_PER_VALUE,
        max_pos=nvfp4.MAX_POS,
        min_pos=nvfp4.MIN_POS,
        local_dynamic_range_binades=3.58,   # log2(6 / 0.5)
        qdq=nvfp4.qdq,
    )
)

NVFP4_PTS = _register(
    BFPFormat(
        name="nvfp4_pts",
        group_size=nvfp4.GROUP_SIZE,
        bits_per_value=nvfp4.BITS_PER_VALUE,
        max_pos=nvfp4.MAX_POS,
        min_pos=nvfp4.MIN_POS,
        local_dynamic_range_binades=3.58,
        qdq=nvfp4.qdq_pts,
        needs_pts=True,
    )
)

MXFP4 = _register(
    BFPFormat(
        name="mxfp4",
        group_size=mxfp4.GROUP_SIZE,
        bits_per_value=mxfp4.BITS_PER_VALUE,
        max_pos=2.0 ** 127 * 6.0,
        min_pos=2.0 ** -127 * 0.5,
        local_dynamic_range_binades=3.58,
        qdq=mxfp4.qdq,
    )
)


def get_format(name: Optional[str]) -> Optional[BFPFormat]:
    """Look up a format; ``None``/"none"/"bf16" mean no quantization."""
    if name is None or name in ("none", "bf16"):
        return None
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown BFP format {name!r}; have {sorted(_REGISTRY)}")


def available_formats() -> list[str]:
    return sorted(_REGISTRY)
