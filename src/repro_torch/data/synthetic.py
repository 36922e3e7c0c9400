"""Deterministic synthetic LM data with checkpointable iterator state (port
of ``repro/data/synthetic.py``).

Tokens follow a noisy affine recurrence over the vocabulary (next = (31 t +
17) mod V, replaced by a uniform draw with probability ``noise``), so a
language model can learn the stream while every batch is a pure function of
(seed, step): restoring :meth:`SyntheticLMDataset.state_dict` replays the
same stream, which is what makes a resumed run follow the uninterrupted
one. The draws come from a CPU ``torch.Generator`` seeded from (seed,
step), so a batch does not depend on the device it is sent to. They are
not the reference's bits (``jax.random`` cannot be replayed here): tests
that compare the packages feed both the reference dataset's batches.
"""
from __future__ import annotations

import dataclasses

import torch

A, C = 31, 17                         # the recurrence's multiplier and offset


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    step: int = 0                     # iterator state (checkpointable)

    # -- checkpointable state -------------------------------------------------

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        if int(d["seed"]) != self.seed:
            raise ValueError(f"dataset seed mismatch on restore: "
                             f"{d['seed']} != {self.seed}")
        self.step = int(d["step"])

    # -- generation -----------------------------------------------------------

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step): {"tokens": (B, S) int64} on the
        CPU."""
        b, s, v = self.global_batch, self.seq_len, self.vocab
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + step)
        t = torch.randint(0, v, (b,), generator=gen)
        jumps = torch.rand((b, s), generator=gen) < self.noise
        rnd = torch.randint(0, v, (b, s), generator=gen)
        toks = torch.empty((b, s), dtype=torch.int64)
        for i in range(s):
            t = torch.where(jumps[:, i], rnd[:, i], (A * t + C) % v)
            toks[:, i] = t
        return {"tokens": toks}

    def __next__(self) -> dict:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self
