"""Logical-axis sharding rules with divisibility fallback (port of
``repro/sharding/rules.py``).

Models annotate tensors with *logical* axis names ("batch", "heads",
"ff", ...). A :class:`ShardCtx` resolves them against a mesh given by its
axis sizes (``{"data": 16, "model": 16}``): a logical axis whose dimension
does not divide the product of its mesh axes falls back to a prefix of
them, else is replicated, and a mesh axis shards at most one dimension.

The port runs eagerly on one card and has no partitioner: the resolution
serves the dry run's residency accounting (per-device shard shapes) only,
so the reference's ``constrain`` has no counterpart. With ``mesh=None``, or
the card's 1 x 1, everything is replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


# logical axis -> tuple of mesh axes it shards over (in order)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),       # data parallel
    "seq": (),                      # unsharded by default
    "act_seq": ("model",),          # sequence parallel residual stream
    "kv_seq": ("model",),           # context-parallel KV cache (decode)
    "embed": (),                    # d_model replicated by default
    "heads": ("model",),            # TP over attention heads
    "attn_q_chunks": ("model",),    # vec_q flash: q chunks over TP
    "kv_heads": ("model",),         # TP over KV heads
    "ff": ("model",),               # TP over the FFN hidden
    "experts": ("model",),          # EP over experts
    "vocab": ("model",),            # TP over vocab for embed/head
    "ssm_inner": ("model",),        # TP over mamba d_inner
    "layers": (),                   # the stacked-layer axis never shards
    "opt_shard": ("pod", "data"),   # ZeRO-1 axis for optimizer state
    "fsdp": ("data",),              # FSDP: the non-TP weight axis over DP
}

@dataclasses.dataclass
class ShardCtx:
    """Resolves logical specs against a mesh of named axis sizes; a None
    mesh replicates everything."""

    mesh: Optional[dict] = None
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))

    def with_rules(self, **overrides: tuple) -> "ShardCtx":
        r = dict(self.rules)
        r.update(overrides)
        return ShardCtx(mesh=self.mesh, rules=r)

    def _size(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh[a] for a in axes)

    def _axes_for(self, logical: Optional[str], dim: int) -> Optional[tuple]:
        if logical is None or self.mesh is None:
            return None
        mesh_axes = tuple(a for a in self.rules.get(logical, ())
                          if a in self.mesh)
        if not mesh_axes:
            return None
        if dim % self._size(mesh_axes):
            # divisibility fallback: a prefix of the axes, else replicate
            for cut in range(len(mesh_axes) - 1, 0, -1):
                if dim % self._size(mesh_axes[:cut]) == 0:
                    return mesh_axes[:cut]
            return None
        return mesh_axes

    def pspec(self, logical_axes: Sequence[Optional[str]],
              shape: Sequence[int]) -> tuple:
        """The mesh axes of each dim (None, one axis, or a tuple)."""
        if len(logical_axes) != len(shape):
            raise ValueError(f"axes {logical_axes} vs shape {shape}")
        used: set = set()
        parts = []
        for name, dim in zip(logical_axes, shape):
            axes = self._axes_for(name, dim)
            if axes is None or any(a in used for a in axes):
                parts.append(None)
            else:
                used.update(axes)
                parts.append(axes if len(axes) > 1 else axes[0])
        return tuple(parts)

    def shard_shape(self, logical_axes: Sequence[Optional[str]],
                    shape: Sequence[int]) -> tuple:
        """The per-device shape of a tensor of ``shape`` under the spec."""
        out = []
        for part, dim in zip(self.pspec(logical_axes, shape), shape):
            if part is None:
                out.append(dim)
            else:
                out.append(dim // self._size(
                    part if isinstance(part, tuple) else (part,)))
        return tuple(out)
