"""Checkpoints of parameter trees, byte-compatible with the reference's
(``repro/checkpoint``), and the async manager of the train loop."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    CheckpointCorruptError,
    CheckpointError,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
