"""Sensitivity probe: per-site quantization-error scores from one bf16 pass
(port of ``repro/calibrate/probe.py``).

Runs the calibration batches through the model ONCE in bf16 with the
per-site activation tap installed (:mod:`repro_torch.core.tap`: the capture
hooks ride ``ModelCtx.site_quant`` and the engine funnel, so every family's
dense/qbmm sites record without model changes), then scores every site the
resolved :class:`~repro_torch.core.policy.QuantPlan` enumerates:

* **error per format** (:data:`repro_torch.core.metrics.QDQ_FORMATS` +
  bf16): relative layer-output error ``||X(W - Wq)||_F / ||X W||_F``
  against the site's captured activations, per layer, averaged over the
  stack. HiF4 is additionally scored with HiGPTQ offline rounding
  (:mod:`repro_torch.core.higptq`) wherever the site structurally admits an
  offline artifact: that rounded score is the one the frontier search
  prices, and the direct cast's stays as ``hif4_direct``;
* **byte residency per format**: 0.5625 B/value for HiF4 on a packable
  site (the PackedW payload), 2 B/value (bf16 at rest) everywhere else,
  what ``prepare_params_for_serving`` + the plan's ``packed_paths`` make
  resident;
* **roofline latency contribution**: site bytes / measured stream
  bandwidth, when a bandwidth is supplied.

The forward is the cache-free ``lm._backbone(..., mode="train")`` of any
family with no plan, so it launches no kernel of the port; the scoring is
plain PyTorch on the params' device. Report rows hold plain Python numbers
(the reference's JSON schema).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tap as site_tap
from repro_torch.core.formats import get_format
from repro_torch.core.higptq import higptq_quantize_layers
from repro_torch.core.metrics import QDQ_FORMATS, rel_output_error
from repro_torch.core.policy import QuantPlan, get_policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelCtx

# byte costs at rest: the PackedW payload (4.5-bit codes + scale metadata)
# vs bf16
PACKED_BPV = 0.5625
DENSE_BPV = 2.0

# sites the byte budget governs are the matmul weight sites that own a
# resident tensor: "embed" is a gather table the policy clamps to fmt='none',
# and a tied "lm_head" owns no tensor of its own (it reads embed.T) (see
# _in_budget).


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Everything the search + emitter need, plus the audit rows."""

    arch: str
    family: str
    plan: QuantPlan              # uniform:hif4/packed reference resolution
    rows: tuple                  # per-site audit dicts (report schema)
    n_batches: int
    seq_len: int
    batch: int
    seed: int
    n_calib_rows: int            # activation rows captured per site (min)
    mem_bw: Optional[float]      # bytes/s, None = no roofline measurement

    def site_scores(self):
        """The searchable score table (:mod:`repro_torch.calibrate.search`)."""
        from repro_torch.calibrate.search import FormatOption, SiteScore

        out = []
        for r in self.rows:
            if not r["in_budget"]:
                continue
            opts = [FormatOption("bf16", DENSE_BPV, 0.0)]
            if r["packable"]:
                opts.append(FormatOption("hif4", PACKED_BPV, r["errors"]["hif4"]))
            out.append(SiteScore(path=r["path"], n_values=r["n_values"],
                                 options=tuple(opts)))
        return out


def _forward(params, batch, cfg, ctx):
    """One captured bf16 forward: prompt -> logits, any family (the audio
    decoder reads 4 BOS tokens against the encoded frames)."""
    if cfg.family == "audio":
        frames = batch["frames"]
        bos = torch.zeros((frames.shape[0], 4), dtype=torch.long,
                          device=frames.device)
        x = lm.embed_tokens(params, bos, cfg, ctx)
        x = x + lm.sinusoid(torch.arange(x.shape[1], device=x.device),
                            cfg.d_model).to(x.dtype)
        h, _ = lm._backbone(params, x, cfg, ctx, mode="train", frames=frames)
    elif cfg.embeds_input:
        x = batch["embeds"].to(ctx.compute_dtype)
        h, _ = lm._backbone(params, x, cfg, ctx, mode="train")
    else:
        x = lm.embed_tokens(params, batch["tokens"], cfg, ctx)
        h, _ = lm._backbone(params, x, cfg, ctx, mode="train")
    return lm.lm_logits(params, h, cfg, ctx)


def _in_budget(site, params) -> bool:
    if site.path == "embed":
        return False
    if site.path == "lm_head" and "lm_head" not in params:
        return False                                  # tied: reads embed.T
    return True


def _site_k(site) -> Optional[int]:
    """Contraction width K of one (stacked) site, from its plan record."""
    if site.contract_axes:
        return math.prod(site.shape[a] for a in site.contract_axes)
    if len(site.shape) >= 2:
        return int(site.shape[0])    # tied lm_head: (d, V) contracts d
    return None


def _stacked(site) -> bool:
    return site.path.split(".")[0] in ("blocks", "shared", "enc_blocks")


def _to_matrix(w: torch.Tensor, ca: tuple) -> torch.Tensor:
    m = torch.movedim(w, ca, tuple(range(len(ca))))
    return m.reshape(math.prod(m.shape[:len(ca)]), -1)


def _weight_matrices(params, site) -> list:
    """Per-layer (K, N) contraction-major float32 matrices for one site."""
    node = params
    for part in site.path.split("."):
        if part not in node:
            if site.path == "lm_head":          # tied: reads embed.T
                return [params["embed"].to(torch.float32).T]
            raise KeyError(f"no param tensor at site {site.path!r}")
        node = node[part]
    w = node.to(torch.float32)
    if not _stacked(site):
        return [_to_matrix(w, site.contract_axes or (0,))]
    ca = tuple(a - 1 for a in site.contract_axes) or (0,)
    return [_to_matrix(w[l], ca) for l in range(w.shape[0])]


def _score_site(site, w_layers, x_layers, n_samples: int,
                clock: Optional[list] = None) -> dict:
    """Per-format mean layer-output error for one site; ``clock[0]``
    accumulates the seconds of HiGPTQ (each error's ``float()`` waits for
    the device, so the host clock brackets the work)."""
    errors = {f: [] for f in QDQ_FORMATS}
    higptq_errs = []
    x_layers = [x_l[:n_samples] for x_l in x_layers]
    for w_l, x_l in zip(w_layers, x_layers):
        for f in QDQ_FORMATS:
            wq = get_format(f).qdq(w_l.T).T
            errors[f].append(rel_output_error(w_l, wq, x_l))
    if site.quantize_offline and w_layers[0].shape[0] % 64 == 0:
        t0 = time.perf_counter()
        # the stack's layers together: one launch per row step for all
        wg = higptq_quantize_layers(torch.stack(w_layers), x_layers)
        higptq_errs = [rel_output_error(w_l, wg_l, x_l)
                       for w_l, wg_l, x_l in zip(w_layers, wg, x_layers)]
        if clock is not None:
            clock[0] += time.perf_counter() - t0
    out = {f: float(np.mean(errors[f])) for f in QDQ_FORMATS}
    out["bf16"] = 0.0
    out["hif4_direct"] = out["hif4"]
    if higptq_errs:
        # what serving ships for a packed site: the HiGPTQ-rounded weight
        out["hif4"] = float(np.mean(higptq_errs))
    return out


def _batch_to(batch: dict, dev: torch.device) -> dict:
    """Prefill inputs (tensors or numpy arrays) on ``dev``: token ids as
    int64, frames and embeds as they are."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        out[k] = t.to(device=dev, dtype=torch.long if k == "tokens" else t.dtype)
    return out


def probe_sites(cfg: ArchConfig, *, params: Optional[dict] = None,
                n_batches: int = 2, batch: int = 2, seq_len: int = 64,
                seed: int = 0, n_samples: int = 256,
                mem_bw: Optional[float] = None, log=print,
                batches: Optional[Sequence[dict]] = None,
                device: DeviceLike = None, timings: Optional[dict] = None
                ) -> CalibrationResult:
    """Run the calibration pass and score every plan site (see module
    docstring). ``params`` defaults to the seeded random init the serve
    launcher draws (``lm.init_params(cfg, seed)``); ``batches`` to
    ``n_batches`` prefill batches of (batch, seq_len) drawn from ``seed + i``
    (:func:`repro_torch.runtime.scenario.prefill_batch`): given, they are the
    calibration set (dicts of tensors or numpy arrays, e.g. the reference's)
    and set n_batches, batch and seq_len. ``timings`` (a dict) receives the
    seconds of the forward (``probe_s``), of HiGPTQ (``higptq_s``) and of
    the rest of the scoring (``score_s``)."""
    dev = resolve_device(device)
    if params is None:
        params = lm.init_params(cfg, seed, device=dev)
    if batches is None:
        from repro_torch.runtime.scenario import prefill_batch

        batches = [prefill_batch(cfg, batch, seq_len, seed + i, dev)
                   for i in range(n_batches)]
    batches = [_batch_to(b, dev) for b in batches]
    n_batches = len(batches)
    batch, seq_len = next(iter(batches[0].values())).shape[:2]
    plan = lm.quant_plan(cfg, get_policy("uniform:hif4", impl="packed"))
    ctx = ModelCtx(attn_q_chunk=8, attn_k_chunk=8)

    expect_k = {}
    for s in plan.sites:
        k = _site_k(s)
        if k is not None and s.path != "embed":
            expect_k[s.path] = k
    t = site_tap.ActivationTap(expect_k=expect_k)
    t0 = time.perf_counter()
    with torch.no_grad(), site_tap.capture(t):
        for b in batches:
            _forward(params, b, cfg, ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    probe_s = time.perf_counter() - t0
    log(f"[calibrate] probe: {n_batches} batches of ({batch}, {seq_len}) "
        f"through {cfg.family} forward; {len(t.paths())} sites captured")

    rows = []
    n_min = None
    higptq_s = [0.0]
    t0 = time.perf_counter()
    with torch.no_grad():
        for s in sorted(plan.sites, key=lambda s: s.path):
            in_budget = _in_budget(s, params)
            row = {
                "path": s.path,
                "n_values": int(s.n_values),
                "shape": [int(d) for d in s.shape],
                "packable": bool(s.packed),
                "in_budget": in_budget,
                "captured": s.path in t.records,
            }
            if s.path == "embed" or s.path not in t.records:
                # no matmul consumed this site this pass (embed is a
                # gather); keep the row for the audit but give the search
                # nothing to trade
                row.update({"errors": None, "bytes": None, "roofline_ms": None})
                rows.append(row)
                continue
            L = s.shape[0] if _stacked(s) else 1
            w_layers = _weight_matrices(params, s)
            x_layers = [t.rows(s.path, layer=l, n_layers=L) for l in range(L)]
            n_min = min(n_min or 10 ** 9, min(x.shape[0] for x in x_layers))
            row["errors"] = _score_site(s, w_layers, x_layers, n_samples,
                                        higptq_s)
            bpv = {f: DENSE_BPV for f in list(QDQ_FORMATS) + ["bf16"]}
            if s.packed:
                bpv["hif4"] = PACKED_BPV
            row["bytes"] = {f: round(b * s.n_values) for f, b in bpv.items()}
            if mem_bw:
                row["roofline_ms"] = {
                    f: round(b / mem_bw * 1e3, 6) for f, b in row["bytes"].items()}
            else:
                row["roofline_ms"] = None
            rows.append(row)
    score_s = time.perf_counter() - t0 - higptq_s[0]
    if timings is not None:
        timings.update(probe_s=probe_s, higptq_s=higptq_s[0], score_s=score_s)

    return CalibrationResult(
        arch=cfg.name, family=cfg.family, plan=plan, rows=tuple(rows),
        n_batches=n_batches, seq_len=int(seq_len), batch=int(batch), seed=seed,
        n_calib_rows=int(n_min or 0), mem_bw=mem_bw)
