"""Format registry (port of ``repro/core/formats.py``).

``get_format(name)`` returns a :class:`BFPFormat` whose ``qdq(x, axis)`` maps
a tensor to its nearest representable tensor in that format. This slice of
the port carries ``hif4`` (and ``none``); the NVFP4/MXFP4 baselines raise
"not yet ported" until their slice lands.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import hif4


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

# formats of the reference that this port does not carry yet
NOT_YET_PORTED = ("nvfp4", "nvfp4_pts", "mxfp4")


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


def get_format(name: Optional[str]) -> Optional[BFPFormat]:
    """Look up a format; ``None``/"none"/"bf16" mean no quantization."""
    if name is None or name in ("none", "bf16"):
        return None
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"BFP format {name!r} is not yet ported to repro_torch "
            f"(have {sorted(_REGISTRY)})")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown BFP format {name!r}; have {sorted(_REGISTRY)}")
