"""Serving launcher of the PyTorch port: offline HiF4 packing + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --policy paper-iv --impl packed --kv-format hif4          # on cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --device cpu --batch 2 --prompt-len 8 --new-tokens 4

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --reduced --device cpu --batch 2 --prompt-len 8 --new-tokens 4 \
        --policy paper-iv --impl packed --kv-format hif4 \
        --kv-pages 8 --kv-page-tokens 8                   # paged scheduler
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --impl pallas --kv-format hif4 --policy head.json   # on cuda

``--impl pallas`` packs the block weights (kernels 1 and 2, as ``packed``)
and runs a quantized dense weight through the fixed-point route: with a
policy JSON whose rules quantize ``lm_head`` (e.g. ``*`` -> hif4, then
``embed`` and ``*.router`` -> none), the tied LM head quantizes the
activations (kernel 1) and the embedding on every call: at most 32 rows in
the loader of kernel 5's decode form (``bfp_decode_matmul``), above by
kernel 1 again, then ``bfp_matmul_quantized`` (kernel 5). ``--quant`` and
``uniform:<fmt>`` take hif4, nvfp4, nvfp4_pts and mxfp4; the baselines, and
``--policy nvfp4-baseline``, serve fake-quant (no packed container exists
for them).

Prints the same residency, plan and dispatch lines as the JAX launcher
(``repro.launch.serve``), then one line of tokens per request. Weights are
random, made from ``--seed``; prompts too: token ids, or for the families
whose frontend is a stub (the reference's too) f32 normals of shape (batch,
prompt_len, d_model), LLaVA's patch embeddings (``embeds``) or whisper's
encoder frames (``frames``), drawn on the chosen device. ``--kv-pages N``
serves the requests through the paged HiF4 pool scheduler and prints its
counters.

``--guard`` arms the health sentinels (NaN/Inf logits flag, per-chunk
0xFF-meta and page-checksum audits, quarantine + qdq/bf16 fallback retry)
and prints a status per request; ``--deadline-s`` adds a per-request
deadline and ``--inject-fault kind[:key=value,...]`` one deterministic
fault (both imply ``--guard``), e.g.
``--inject-fault page_corruption:seed=1,target_request=1,after_chunk=1``.
``--journal-dir DIR`` makes the serve crash-safe (write-ahead journal, and
with ``--checkpoint-every N`` a pool checkpoint every N chunks); after a
crash, including an injected ``crash_*`` fault, ``--resume`` recovers from
DIR and prints the recovery report. These route serving through the
request scheduler, which serves token prompts only (the launcher refuses
them for embeds and frames, with the reference's reasons)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --reduced --device cpu --batch 2 --prompt-len 8 --new-tokens 6 \
        --decode-chunk 2 --kv-format hif4 --kv-pages 12 --kv-page-tokens 8 \
        --journal-dir DIR --checkpoint-every 1 \
        --inject-fault crash_mid_decode:after_chunk=1     # then --resume
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_arch
from repro_torch.core import kvcache
from repro_torch.core.engine import (
    attention_dispatch_info,
    dense_dispatch_info,
    packed_dispatch_info,
)
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import PackedW, QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx
from repro_torch.runtime import faults
from repro_torch.runtime.guard import GuardConfig
from repro_torch.runtime.journal import journal_residency
from repro_torch.runtime.scenario import prefill_batch
from repro_torch.runtime.serve_loop import (
    ServeConfig,
    packed_weight_bytes,
    prepare_params_for_serving,
    resolve_kv_format,
    serve,
    serve_requests,
)


def _leaf_at(tree, path: str):
    node = tree
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _print_plan(plan, serving_params):
    """The resolved policy plan, one line per site."""
    print(f"policy plan [{plan.policy.name}] "
          f"({len(plan.packed_paths)}/{len(plan.sites)} sites packed):")
    print(f"  {'site':<18} {'fmt':<10} {'impl':<7} {'resident artifact':<34} "
          f"{'bytes':>12}")
    for site in plan.sites:
        leaf = _leaf_at(serving_params, site.path)
        if isinstance(leaf, PackedW):
            nbytes = leaf.nbytes_packed
            art = f"PackedW 4.5-bit ({nbytes / leaf.n_values:.4f} B/value)"
        elif leaf is None:
            nbytes = 0
            art = "(tied -> embed)" if site.path == "lm_head" else "(absent)"
        else:
            nbytes = leaf.numel() * leaf.element_size()
            dt = str(leaf.dtype).replace("torch.", "")
            art = (f"qdq {dt} (offline PTQ)"
                   if site.cfg.enabled and site.quantize_offline else dt)
        print(f"  {site.path:<18} {site.cfg.fmt:<10} {site.cfg.impl:<7} "
              f"{art:<34} {nbytes:>12,}")


def _packed_leaves(tree) -> list:
    """The PackedW leaves in the reference's pytree order (sorted keys),
    per-layer slices of the stacked ones."""
    if isinstance(tree, PackedW):
        return [tree.layer(0) if tree.codes.ndim > (2 if tree.kernel_layout
                                                    else 3) else tree]
    if isinstance(tree, dict):
        return [pw for k in sorted(tree) for pw in _packed_leaves(tree[k])]
    return []


def _print_kernel_dispatch(serving_params, ctx, args, device):
    pws = _packed_leaves(serving_params)
    if not pws:
        return
    pw = pws[0]
    info = packed_dispatch_info(ctx.quant, pw, decode_m=args.batch,
                                prefill_m=args.batch * args.prompt_len,
                                device=device)
    if not info["fused"]:
        print("packed matmul: dequantize-then-dot fallback "
              "(fused kernel needs impl=packed|pallas, fmt=hif4, "
              "both-operand quantization)")
        return
    k, n = pw.shape2d
    line = f"packed matmul: fused [{info['execution']}] on e.g. (K={k}, N={n})"
    if info["decode_tiles"] is not None:
        line += (f"; decode {info['decode_kernel']}={info['decode_tiles']}, "
                 f"prefill {info['prefill_kernel']}={info['prefill_tiles']}")
    print(line)
    # the decode linears whose K range the decode form cannot hold
    for other in {w.shape2d: w for w in pws[1:]}.values():
        o = packed_dispatch_info(ctx.quant, other, decode_m=args.batch,
                                 prefill_m=args.batch * args.prompt_len,
                                 device=device)
        if o["decode_kernel"] != info["decode_kernel"]:
            k, n = other.shape2d
            print(f"packed matmul: fused [{o['execution']}] on (K={k}, N={n}); "
                  f"decode {o['decode_kernel']}={o['decode_tiles']}")


def _print_head_dispatch(cfg, ctx, args, device):
    """The LM head's line when it runs the dense pallas route: every call
    has one row per request (the prefill's last position, then each decode
    step's token)."""
    info = dense_dispatch_info(ctx.site_quant("lm_head"), cfg.d_model,
                               cfg.vocab, m=args.batch, device=device)
    if not info["pallas"]:
        return
    line = (f"dense matmul (lm_head): [{info['execution']}] on (K={cfg.d_model}, "
            f"N={cfg.vocab})")
    if info["route"] is not None:
        line += f"; {args.batch} rows: {info['route']} plan={info['plan']}"
    print(line)


def _print_attention_dispatch(cfg, ctx, capacity, device, page_tokens=0):
    """The packed-KV decode attention line; with ``page_tokens`` it answers
    for the page pool (per-layer leaves (NP, F, P), tile = page)."""
    a = cfg.attn
    g, t = kvcache.split_features(a.n_kv_heads, a.d_head)
    cols = page_tokens or capacity
    probe = {"codes": torch.empty((1, g * 32, cols), dtype=torch.uint8, device="meta"),
             "meta": torch.empty((1, g, cols), dtype=torch.int32, device="meta"),
             "tail": torch.empty((1, t, cols), dtype=torch.bfloat16, device="meta")}
    info = attention_dispatch_info(ctx.quant, probe, n_kv_heads=a.n_kv_heads,
                                   d_head=a.d_head, device=device,
                                   paged=bool(page_tokens))
    where = (f"{kvcache.pages_for_tokens(capacity, page_tokens)} pages of "
             f"{page_tokens} tokens per slot" if page_tokens
             else f"{capacity} slots")
    print(f"packed attention: {'fused' if info['fused'] else 'plain'} "
          f"[{info['execution']}] {info['route']}, kv tile {info['block_kv']} "
          f"of {where}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--quant", default="hif4",
                    help="format without --policy: hif4, nvfp4, nvfp4_pts, "
                         "mxfp4 or none")
    ap.add_argument("--impl", default="packed", choices=["qdq", "packed", "pallas"])
    ap.add_argument("--decode-chunk", type=int, default=0,
                    help="tokens between host checks of the eos mask")
    ap.add_argument("--kv-format", default="bf16", choices=list(kvcache.KV_FORMATS))
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="> 0: paged KV pool with this many pages (page-granular "
                         "admission + COW prefix sharing; needs --kv-format hif4)")
    ap.add_argument("--kv-page-tokens", type=int, default=kvcache.DEFAULT_PAGE_TOKENS,
                    help="tokens per KV pool page")
    ap.add_argument("--policy", default=None,
                    help="per-site quantization policy: paper-iv, "
                         "nvfp4-baseline, sensitive-fallback, uniform:<fmt> "
                         "or a policy JSON")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--guard", action="store_true",
                    help="arm the serving health sentinels: NaN flag, packed-KV "
                         "audits, quarantine + fallback retry, per-request "
                         "status reports")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline (implies --guard)")
    ap.add_argument("--inject-fault", default=None, metavar="SPEC",
                    help="deterministic fault injection, kind[:key=value,...] "
                         "with kinds " + "/".join(faults.FAULT_CLASSES)
                         + " (implies --guard)")
    ap.add_argument("--journal-dir", default=None, metavar="DIR",
                    help="crash-safe serving: write-ahead request journal "
                         "(+ pool checkpoints) under DIR")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="durable pool checkpoint every N decode chunks "
                         "(0 = journal only; paged scheduler)")
    ap.add_argument("--resume", action="store_true",
                    help="recover from the journal in --journal-dir")
    return ap.parse_args(argv)


def _print_kv_residency(cfg, ctx, args, kv_fmt, cap, device):
    """The KV residency line (the page pool's with ``--kv-pages``), counted
    over ``n_layers`` as the reference counts it, and the packed attention
    line for hif4 KV."""
    a = cfg.attn
    per_tok = kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head, kv_fmt) * cfg.n_layers
    bf16_tok = kvcache.kv_bytes_per_token(a.n_kv_heads, a.d_head, "bf16") * cfg.n_layers
    if args.kv_pages:
        pg = kvcache.page_nbytes(a.n_kv_heads, a.d_head, args.kv_page_tokens,
                                 cfg.n_layers)
        print(f"kv page pool [{kv_fmt}]: {args.kv_pages} pages x "
              f"{args.kv_page_tokens} tokens ({pg} B/page) = "
              f"{args.kv_pages * pg / 2**20:.2f} MiB (whole-slot equivalent: "
              f"{per_tok * cap * args.batch / 2**20:.2f} MiB for "
              f"{args.batch} slots x {cap} capacity)")
    else:
        total = per_tok * cap * args.batch
        print(f"kv cache residency [{kv_fmt}]: {per_tok} B/token "
              f"(bf16: {bf16_tok}) x {cap} capacity x {args.batch} slots "
              f"= {total / 2**20:.2f} MiB"
              + (f"  [{bf16_tok / per_tok:.2f}x more slots per byte]"
                 if kv_fmt == "hif4" else ""))
    if kv_fmt == "hif4":
        _print_attention_dispatch(cfg, ctx, cap, device,
                                  args.kv_page_tokens if args.kv_pages else 0)


def _print_journal_residency(directory):
    res = journal_residency(directory)
    print(f"journal residency [{directory}]: {res['journal_bytes']} B journal, "
          f"{res['checkpoints']} checkpoint(s) = {res['checkpoint_bytes']} B")


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    try:
        cfg = get_arch(args.arch)
    except ValueError as e:                     # an unknown arch
        print(e, file=sys.stderr)
        return 2
    if args.reduced:
        cfg = cfg.reduced()
    kv = kvcache.KVCacheConfig(args.kv_format)
    plan = None
    if args.policy is not None:
        plan = lm.quant_plan(cfg, get_policy(args.policy, impl=args.impl, kv=kv))
        quant = plan.base
    else:
        quant = QuantConfig(fmt=args.quant, impl=args.impl, kv=kv)
    ctx = ModelCtx(quant=quant, plan=plan, attn_q_chunk=32, attn_k_chunk=32)

    params = lm.init_params(cfg, args.seed, device=device)
    serving_params = prepare_params_for_serving(params, cfg, plan or quant,
                                                device=device)
    if plan is not None:
        _print_plan(plan, serving_params)
    nbytes, nvals = packed_weight_bytes(serving_params)
    if nvals:
        print(f"packed weight residency: {nbytes / 2**20:.2f} MiB for "
              f"{nvals} values = {nbytes / nvals:.4f} B/value "
              f"(bf16 would be {2 * nvals / 2**20:.2f} MiB)")
        _print_kernel_dispatch(serving_params, ctx, args, device)
        _print_head_dispatch(cfg, ctx, args, device)
    else:
        print(f"impl={args.impl}: no packed weights resident "
              f"(fake-quant bf16 artifact)")

    guard = None
    if args.guard or args.deadline_s is not None or args.inject_fault:
        guard = GuardConfig(deadline_s=args.deadline_s)
    injector = (faults.FaultInjector(faults.parse_fault(args.inject_fault))
                if args.inject_fault else None)
    sc = ServeConfig(max_new_tokens=args.new_tokens, decode_chunk=args.decode_chunk,
                     kv_pages=args.kv_pages, kv_page_tokens=args.kv_page_tokens,
                     guard=guard, journal_dir=args.journal_dir,
                     checkpoint_every=args.checkpoint_every)
    a = cfg.attn
    # the attention-free family has no KV; the hybrid's falls back to bf16
    # (a KVFallbackWarning, as the reference prints it)
    kv_fmt = None if a is None else resolve_kv_format(cfg, ctx.quant, sc,
                                                        verbose=True)
    scheduled = guard is not None or args.journal_dir is not None
    if (args.kv_pages or scheduled) and cfg.embeds_input:
        print("--kv-pages serves token requests (dense/vlm-embeds not "
              "supported by the paged scheduler entry)" if args.kv_pages else
              "--guard/--inject-fault/--journal-dir serve token requests "
              "through the request scheduler (dense/vlm-embeds not supported)",
              file=sys.stderr)
        return 2
    if args.kv_pages and kv_fmt != "hif4":
        print("--kv-pages requires --kv-format hif4 on a KV-cache family (the "
              "page pool stores packed HiF4 pages)", file=sys.stderr)
        return 2
    if scheduled and cfg.family not in lm.KV_FAMILIES:
        print(f"--guard/--inject-fault/--deadline-s/--journal-dir serve "
              f"through the request scheduler: continuous batching supports "
              f"KV-cache families, got {cfg.family!r}", file=sys.stderr)
        return 2
    cap = args.prompt_len + args.new_tokens
    if a is None:
        print("kv cache residency: n/a (attention-free family)")
    else:
        _print_kv_residency(cfg, ctx, args, kv_fmt, cap, device)

    batch = prefill_batch(cfg, args.batch, args.prompt_len, args.seed + 1, device)
    sparams = serving_params if nvals else params
    stats = None
    try:
        if args.kv_pages or scheduled:
            # paged, guarded or journaled serving is per request: the
            # request scheduler (paged with --kv-pages)
            stats = {}
            res = serve_requests(cfg, sparams, list(batch["tokens"]), ctx, sc,
                                 slots=args.batch, stats=stats, device=device,
                                 injector=injector, resume=args.resume)
            if args.kv_pages:
                print(f"paged scheduler: max {stats['max_concurrent']} "
                      f"concurrent, {stats['shared_page_hits']} shared-page "
                      f"hits, {stats['preemptions']} preemptions, "
                      f"{stats['evictions']} LRU evictions, peak "
                      f"{stats['peak_live_pages']}/{args.kv_pages} pages live")
            toks = torch.stack(res)
        else:
            toks = serve(cfg, sparams, batch, ctx, sc, device=device)
    except faults.SimulatedCrash as crash:
        # the injected process kill: report what the journal holds and exit
        # cleanly, so a --resume run can follow
        print(f"simulated crash: {crash}")
        if args.journal_dir is not None:
            _print_journal_residency(args.journal_dir)
        print("resume with: --journal-dir", args.journal_dir, "--resume")
        return 0
    if args.journal_dir is not None:
        _print_journal_residency(args.journal_dir)
        if args.resume and "recovery" in stats:
            rec = stats["recovery"]
            print(f"recovery report: {rec['completed']} journaled results "
                  f"injected, {rec['replayed']} residents restored from "
                  f"checkpoint, {rec['re_prefilled']} re-prefilled, "
                  f"{rec['dropped_bytes']} torn journal bytes dropped, "
                  f"{rec['verified']} replay prefixes verified bitwise "
                  f"({rec['recovery_ms']:.1f} ms plan build)")
    if injector is not None:
        for kind, detail in injector.events:
            print(f"injected fault: {kind} {detail}")
    if guard is not None:
        counts = {k: stats[k] for k in
                  ("quarantined", "retried", "rejected", "timeouts")}
        print(f"guarded serving: {counts}")
        for rid in sorted(stats["reports"]):
            rep = stats["reports"][rid]
            line = f"request {rid}: status={rep['status']}"
            if rep["detail"]:
                line += f" ({rep['detail']})"
            print(line)
    for i in range(args.batch):
        print(f"request {i}: {toks[i].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
