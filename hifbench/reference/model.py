"""The plain reference of the served models, and the gaps it reads.

``gaps`` runs each sampled request's prompt with the tokens the program
served after it (teacher forcing) through the model, layer by layer: each
layer's weights are drawn again from the seed (:mod:`.draw`), quantized
again (:mod:`.hif4`: the HiF4 sites of policy paper-iv, every linear layer
of a block, weights and activations along K in groups of 64) and freed
before the next. At each served position it reads the gap by which the
served token's logit lies below the best logit there.

A family's block lives in a module of its own, found by the configuration's
``family`` (``dense.py``, ``ssm.py``): its leaves, its weights' quantization
and the block itself. So a new family arrives as a new file.

It computes in the precision the configuration states. Arithmetic is
float32 with TF32 off; what the configuration stores in bf16 is rounded to
bf16 where it is stored (``r``): the residual stream, the norms' outputs,
every linear's output, q and k after RoPE, attention's output and its
softmax weights (the flash tiles' unnormalized weights in a prompt, in the
configuration's tiles; the decode cache's tiles' normalized weights), the
SSM's conv (term by term in the prompt, summed in float32 after it, as the
prefill and the decode step state), its scan's output and its gate.

The control (``control=True``) runs a second stream beside the first in the
nearest precision below the configuration's: what it stores in bf16 it
stores in fp8 (e4m3, one scale a row), and the LM head's weight too. At
each served position it reads the reference's gap of the token the control
puts first.

Nothing here imports the program; the inputs are the weight table, the seed
and the tokens, all plain data.
"""
from __future__ import annotations

import importlib

import torch

from . import draw
from .ops import F32, bf16, fp8_rows, rms, strict_float32

HEAD_SLAB = 32768


def family(m: dict):
    """The module of the model's family: ``block_leaves``, ``weights``,
    ``block``."""
    try:
        return importlib.import_module(f"{__package__}.{m['family']}")
    except ModuleNotFoundError:
        raise ValueError(f"no reference for family {m['family']!r}") from None


# ---------------------------------------------------------------------------
# The weight table (the reference's own declaration of the model's leaves)
# ---------------------------------------------------------------------------


def _leaf(path, shape, *, stacked, init="normal", std=0.02, dtype="bfloat16"):
    return {"path": path, "shape": list(shape), "stacked": stacked,
            "dtype": dtype, "init": init, "std": std}


def leaf_table(m: dict, init: dict | None = None) -> list:
    """Every leaf of the model ``m`` (the configuration's numbers), in the
    order the draws take, with the configuration's initializer overrides."""
    d, V, L = m["d_model"], m["vocab"], m["n_layers"]
    leaves = [_leaf("embed", (V, d), stacked=False),
              _leaf("final_norm.w", (d,), stacked=False, init="ones")]
    if not m["tie_embeddings"]:
        leaves.append(_leaf("lm_head", (d, V), stacked=False))
    for spec in family(m).block_leaves(m):
        name, shape = spec[0], spec[1]
        kind = spec[2] if len(spec) > 2 else "normal"
        std = spec[3] if len(spec) > 3 else 0.02
        dtype = spec[4] if len(spec) > 4 else "bfloat16"
        leaves.append(_leaf("blocks." + name, (L,) + tuple(shape), stacked=True,
                            init=kind, std=std, dtype=dtype))
    for path, over in (init or {}).items():
        hit = [x for x in leaves if x["path"] == path]
        if not hit:
            raise ValueError(f"init override for unknown leaf {path!r}")
        hit[0].update(over)
    return sorted(leaves, key=lambda x: tuple(x["path"].split(".")))


# ---------------------------------------------------------------------------
# The gaps
# ---------------------------------------------------------------------------


def gaps(m: dict, table: list, seed: int, requests: list, device,
         control: bool = False, tiles: tuple | None = None) -> dict:
    """``requests``: [{"prompt": (S,) ints, "served": (T,) ints}]. Returns
    {"gap": (sum T,) float32 on the CPU, the served tokens' gaps in request
    order; with ``control`` also "control_gap", the gaps of the tokens the
    control puts first}."""
    strict_float32()
    m = dict(m, attn_tiles=tiles)
    seqs, rows, row = [], [], 0
    for req in requests:
        S, T = len(req["prompt"]), len(req["served"])
        ids = torch.cat([torch.as_tensor(req["prompt"]),
                         torch.as_tensor(req["served"][:T - 1])]).long()
        seqs.append({"row": row, "n": S + T - 1, "prompt_len": S, "served": T})
        rows.append(ids)
        row += S + T - 1
    ids = torch.cat(rows).to(device)
    top = draw.draw_layer(table, seed, -1, device)
    rounders = [bf16, fp8_rows] if control else [bf16]
    streams = [r(top["embed"][ids].to(F32)) for r in rounders]
    fam = family(m)
    for layer in range(m["n_layers"]):
        w = fam.weights(m, draw.draw_layer(table, seed, layer, device))
        streams = [fam.block(m, w, x, seqs, r) for x, r in zip(streams, rounders)]
        del w
        if ids.is_cuda:
            torch.cuda.empty_cache()
    # the served positions: a request's last prompt token, then each served
    # token but the last
    pick = torch.cat([torch.arange(s["row"] + s["prompt_len"] - 1,
                                   s["row"] + s["n"]) for s in seqs]).to(device)
    served = torch.cat([torch.as_tensor(q["served"]).long()
                        for q in requests]).to(device)
    head = top["embed"].T if m["tie_embeddings"] else top["lm_head"]
    hs = [r(rms(x[pick], top["final_norm.w"], m["norm_eps"]))
          for x, r in zip(streams, rounders)]
    logits = torch.empty(len(pick), m["vocab"], dtype=F32, device=device)
    best_c = torch.full((len(pick),), float("-inf"), dtype=F32, device=device)
    arg_c = torch.zeros(len(pick), dtype=torch.long, device=device)
    for a in range(0, m["vocab"], HEAD_SLAB):
        wf = head[:, a:a + HEAD_SLAB].to(F32)
        logits[:, a:a + HEAD_SLAB] = hs[0] @ wf
        if control:
            lc = hs[1] @ fp8_rows(wf.T).T
            val, idx = torch.max(lc, dim=-1)
            better = val > best_c
            best_c = torch.where(better, val, best_c)
            arg_c = torch.where(better, idx + a, arg_c)
    best = torch.amax(logits, dim=-1)
    out = {"gap": (best - logits.gather(1, served[:, None])[:, 0]).cpu()}
    if control:
        out["control_gap"] = (best - logits.gather(1, arg_c[:, None])[:, 0]).cpu()
    return out
