"""The one traffic generator: a mix file's parameters -> each call's prompts.

A call is one lockstep batch of ``batch`` requests that share a prompt
length and ask for ``new_tokens`` greedy tokens each. The prompt lengths
are the ``levels`` quantiles of a log-uniform law on [low, high], rounded
down to ``multiple_of``; every run serves the same set of lengths, in an
order the seed shuffles anew for each cycle of ``levels`` calls, so seeds
change which tokens and which order, not how much work. Token ids are
uniform over the vocabulary, drawn from (seed, call).
"""
from __future__ import annotations

import math

import torch

from hifbench.reference.draw import mix_seed


def lengths(mix: dict) -> list:
    p = mix["prompt"]
    if p["law"] != "log_uniform":
        raise ValueError(f"unknown prompt-length law {p['law']!r}")
    lo, hi, k, n = p["low"], p["high"], p["multiple_of"], p["levels"]
    out = []
    for i in range(n):
        x = math.exp(math.log(lo) + (i + 0.5) / n * (math.log(hi) - math.log(lo)))
        out.append(min(hi, max(lo, round(x / k) * k)))
    return out


def longest(mix: dict) -> int:
    return max(lengths(mix))


def prompt_len(mix: dict, seed: int, call: int) -> int:
    levels = lengths(mix)
    n = len(levels)
    gen = torch.Generator().manual_seed(mix_seed(seed, "order", call // n))
    return levels[int(torch.randperm(n, generator=gen)[call % n])]


def prompts(mix: dict, seed: int, call: int, vocab: int) -> torch.Tensor:
    """(batch, S) int64 token ids of call ``call``, on the CPU."""
    S = prompt_len(mix, seed, call)
    gen = torch.Generator().manual_seed(mix_seed(seed, "tokens", call))
    return torch.randint(0, vocab, (mix["batch"], S), generator=gen)
