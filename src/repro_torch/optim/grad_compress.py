"""HiF4 gradient compression for the data-parallel all-reduce (port of
``repro/optim/grad_compress.py``).

Gradients have a wide dynamic range across tensors and steps; HiF4's
three-level scale lets them be cast directly, without a per-tensor scale
sweep. The all-reduce moves 4.5 bits/value:

  pack (codes uint8 + meta words)
  -> all_to_all   (each rank owns 1/N of the groups; wire = packed)
  -> local dequantize and f32 mean over the ranks
  -> requantize + pack
  -> all_gather   (wire = packed)

a compressed reduce-scatter/all-gather, 16/4.5 = 3.56x less wire than a
bf16 all-reduce. A local error-feedback accumulator keeps the compound
update unbiased over steps. The collectives are ``torch.distributed``'s
(``all_to_all_single``, ``all_gather_into_tensor``) on the given process
group; without an initialized group, or in a group of one rank, nothing
goes on the wire and the mean is the rank's own requantized value.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import tree_flatten, tree_unflatten
from repro_torch.core import hif4

GROUP = hif4.GROUP_SIZE


def _flatten_to_groups(x: torch.Tensor):
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % GROUP
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, GROUP), n


def qdq_flat(x: torch.Tensor) -> torch.Tensor:
    """HiF4 QDQ of an arbitrary tensor in flat 64-groups (for EF math)."""
    groups, n = _flatten_to_groups(x)
    deq = hif4.dequantize_groups(hif4.quantize_groups(groups))
    return deq.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def pack_flat(x: torch.Tensor):
    """tensor -> (codes (G, 32) uint8, meta (G,) int32 words (uint32 bits),
    orig_len)."""
    groups, n = _flatten_to_groups(x)
    packed = hif4.pack_groups(hif4.quantize_groups(groups))
    return packed.codes, packed.meta, n


def unpack_flat(codes, meta, n, shape, dtype=torch.float32) -> torch.Tensor:
    vals = hif4.dequantize_groups(hif4.unpack_groups(hif4.HiF4Packed(codes,
                                                                     meta)))
    return vals.reshape(-1)[:n].reshape(shape).to(dtype)


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce-mean of ``x`` over ``group`` moving HiF4-packed bytes on
    the wire. Groups are sharded across the ranks in contiguous blocks for
    the reduce-scatter phase (rank i owns block i)."""
    n_dev = _world(group)
    groups, n = _flatten_to_groups(x)
    g = groups.shape[0]
    pad_g = (-g) % n_dev
    if pad_g:
        groups = torch.nn.functional.pad(groups, (0, 0, 0, pad_g))
    packed = hif4.pack_groups(hif4.quantize_groups(groups))

    # reduce-scatter phase: rank i receives block i of every peer
    codes = packed.codes.reshape(n_dev, -1, 32).contiguous()
    meta = packed.meta.reshape(n_dev, -1).contiguous()
    if n_dev > 1:
        codes_x, meta_x = torch.empty_like(codes), torch.empty_like(meta)
        dist.all_to_all_single(codes_x, codes, group=group)
        dist.all_to_all_single(meta_x, meta, group=group)
        codes, meta = codes_x, meta_x
    vals = hif4.dequantize_groups(hif4.unpack_groups(hif4.HiF4Packed(codes,
                                                                     meta)))
    local = torch.mean(vals, dim=0)                     # (g / n_dev, 64) f32

    # all-gather phase: share the requantized partial means
    rs = hif4.pack_groups(hif4.quantize_groups(local))
    codes, meta = rs.codes, rs.meta
    if n_dev > 1:
        # the ranks' blocks end to end along the first axis
        codes_g = codes.new_empty((n_dev * codes.shape[0],) + codes.shape[1:])
        meta_g = meta.new_empty((n_dev * meta.shape[0],))
        dist.all_gather_into_tensor(codes_g, codes.contiguous(), group=group)
        dist.all_gather_into_tensor(meta_g, meta.contiguous(), group=group)
        codes, meta = codes_g, meta_g
    full = hif4.dequantize_groups(hif4.unpack_groups(hif4.HiF4Packed(
        codes, meta))).reshape(-1, GROUP)[:g]
    return full.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def ef_compress_step(grad: torch.Tensor, err: torch.Tensor):
    """Error feedback: returns (compressed value to reduce, new residual)."""
    target = grad.to(torch.float32) + err
    q = qdq_flat(target)
    return q, target - q


def make_dp_compressed_train_step(loss_fn, opt_update, group=None):
    """Data-parallel train step with the HiF4-compressed gradient
    all-reduce: ``step(params, opt_state, err, batch)``, where each rank
    holds the same params and passes its own shard of the batch, and
    ``err`` is the rank's error-feedback tree (f32, zero at the start).
    ``loss_fn(params, batch)`` is the scalar loss, ``opt_update(params,
    grads, opt_state)`` updates in place and returns its stats. Returns
    (params, opt_state, err, stats with the ranks' mean loss)."""
    def step(params, opt_state, err, batch):
        leaves = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        reduced, new_err = [], []
        with torch.no_grad():
            for g, e in zip(grads, tree_flatten(err)):
                q, res = ef_compress_step(g, e)
                reduced.append(compressed_psum(q, group).to(g.dtype))
                new_err.append(res)
            loss = loss.detach().clone()
            if _world(group) > 1:
                dist.all_reduce(loss, group=group)
                loss = loss / _world(group)
        stats = opt_update(params, tree_unflatten(params, reduced), opt_state)
        return params, opt_state, tree_unflatten(params, new_err), dict(stats,
                                                                    loss=loss)

    return step
