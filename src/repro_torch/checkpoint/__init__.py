"""Checkpoints of parameter trees, byte-compatible with the reference's
(``repro/checkpoint``); the async manager waits for the training slice."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointError,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
