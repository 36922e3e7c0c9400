"""Axis<->group reshaping shared by every BFP format (port of
``repro/core/grouping.py``): format code only ever sees (..., group) blocks."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int
                    ) -> tuple[torch.Tensor, int]:
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    axis = axis % x.ndim
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, rem]
    return F.pad(x, pad), n


def to_groups(x: torch.Tensor, axis: int, group: int
              ) -> tuple[torch.Tensor, int]:
    """Return (y, orig_len): y has shape (..., n_groups, group) with the
    grouped axis moved last; pads with zeros if needed."""
    x = torch.movedim(x, axis, -1)
    x, orig = pad_to_multiple(x, group, -1)
    y = x.reshape(x.shape[:-1] + (x.shape[-1] // group, group))
    return y, orig


def from_groups(y: torch.Tensor, axis: int, orig_len: int) -> torch.Tensor:
    x = y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))
    x = x[..., :orig_len]
    return torch.movedim(x, -1, axis)


def apply_grouped(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                  axis: int, group: int) -> torch.Tensor:
    """Apply ``fn`` on (..., group) blocks of ``x`` along ``axis``."""
    y, orig = to_groups(x, axis, group)
    out = fn(y)
    return from_groups(out, axis, orig).to(x.dtype)
