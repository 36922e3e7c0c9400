"""Whether what the timed calls served is right: a sample of the window's
requests, drawn from the seed with the longest prompt in it, run through
the reference (:mod:`hifbench.reference.model`).

The numbers are read from the gap, at each served token of the sample, by
which the served token's logit lies below the reference's best logit at
that position (greedy decoding serves the best token; a sound program
differs by last bits of its arithmetic, which the HiF4 activation
quantization turns into flipped codes, more with depth): the widest gap,
the mean gap, and the largest of the requests' own mean gaps (one request
served wrongly throughout). A cell's file says which it compares and their
limits; the control's numbers are held to the same limits.
"""
from __future__ import annotations

import torch

from hifbench.reference import model as reference
from hifbench.reference.draw import mix_seed


def sample(calls: list, n: int, seed: int) -> list:
    """[(call index, row)] of ``n`` requests of ``calls`` (each {"index",
    "batch", "prompt_len"}): the first row of the call with the longest
    prompt, then others drawn from the seed."""
    pool = [(c["index"], r) for c in calls for r in range(c["batch"])]
    top = max(calls, key=lambda c: (c["prompt_len"], -c["index"]))
    first = (top["index"], 0)
    rest = [p for p in pool if p != first]
    gen = torch.Generator().manual_seed(mix_seed(seed, "judge"))
    order = torch.randperm(len(rest), generator=gen).tolist()
    return [first] + [rest[i] for i in order[:max(0, n - 1)]]


def requests(picks: list, prompts: dict, served: dict) -> list:
    return [{"prompt": prompts[i][r], "served": served[i][r]} for i, r in picks]


def verdict(conf: dict, table: list, seed: int, reqs: list, device,
            control: bool = False) -> dict:
    """The numbers of ``reqs`` under the configuration ``conf``
    (``program``), with ``control`` also the control's (``control``)."""
    ctx = conf.get("ctx", {})
    tiles = (ctx["attn_q_chunk"], ctx["attn_k_chunk"]) if ctx else None
    out = reference.gaps(conf["model"], table, seed, reqs, device,
                         control=control, tiles=tiles)
    sizes = [len(r["served"]) for r in reqs]
    res = {"program": numbers(out["gap"], sizes),
           "served_tokens": int(out["gap"].numel()),
           "gaps": spread(out["gap"])}
    if control:
        res["control"] = numbers(out["control_gap"], sizes)
        res["control_gaps"] = spread(out["control_gap"])
    return res


def numbers(gaps: torch.Tensor, sizes: list) -> dict:
    """The numbers a cell may compare, from the gaps of requests of
    ``sizes`` served tokens each, in order."""
    per_request = [float(g.double().mean()) for g in torch.split(gaps, sizes)]
    return {"widest_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.double().mean()),
            "worst_request_mean_gap": max(per_request)}


def checks(found: dict, limits: dict) -> dict:
    """Each compared number beside its limit."""
    return {key: {"value": found[key], "limit": limit}
            for key, limit in limits.items()}


def holds(checked: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())


def spread(gaps: torch.Tensor) -> dict:
    """How the gaps of a sample lie: the share that are 0 (the reference's
    best token), the mean, and the quantiles."""
    q = torch.quantile(gaps.double(), torch.tensor([0.5, 0.9, 0.99],
                                                   dtype=torch.float64))
    return {"zero_share": float((gaps == 0).double().mean()),
            "mean": float(gaps.double().mean()), "p50": float(q[0]),
            "p90": float(q[1]), "p99": float(q[2]), "max": float(gaps.max())}
