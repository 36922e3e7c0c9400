"""Per-site quantization policy: WHAT gets quantized, decided in one place.

Port of ``repro/core/policy.py`` (same rules, plans, presets and JSON
format, so a policy file written by the JAX package loads unchanged).

The paper quantizes the transformer body to HiF4 while keeping sensitive
tensors (embedding, LM head, MoE router — §IV) in high precision, and its
headline result is a cross-format comparison. Before this module, that
placement was scattered: one global :class:`~repro_torch.core.qlinear.QuantConfig`
applied uniformly, and the *site set* was hardcoded three times (a
``PACKABLE_KEYS`` lookup, a ``parent == "moe"`` exclusion, inline
``NO_QUANT`` at the embed/head/router call sites).

A :class:`QuantPolicy` is an ordered list of :class:`QuantRule`s matching
parameter-tree paths (glob patterns over dotted paths, e.g.
``blocks.*.wq``, ``moe.*``, ``lm_head``) to per-site settings (``fmt``,
``impl``, ``weights_only``). **Later rules win.** The KV-cache format
(``kv``) stays cache-global on the policy. Resolving a policy against a
model's param specs (:func:`QuantPolicy.resolve`, usually via
``repro_torch.models.lm.quant_plan``) produces an explicit :class:`QuantPlan`:
one :class:`SitePlan` per quantizable weight site, carrying the site's
resolved :class:`QuantConfig` and whether the serving artifact packs it to
a 4.5-bit ``PackedW`` (``prepare_params_for_serving`` packs exactly the
sites the plan marks packed — there is no other packing predicate).

Path/pattern semantics:

* A site path is the dotted parameter-tree path with stacked layers
  collapsed (layers share one config because they run under one
  ``lax.scan``): ``blocks.attn.wq``, ``blocks.moe.router``, ``lm_head``.
* A pattern matches a path if it globs the full path **or any trailing
  sub-path** (``attn.wq`` and ``*.attn.wq`` are equivalent; ``moe.*``
  matches ``blocks.moe.wg``). ``*`` is ``fnmatch``-style and crosses
  dots.

Presets (``get_policy``): ``uniform:<fmt>`` (the back-compat shim —
bitwise-identical to the old global config, including the §IV
exclusions), ``paper-iv`` (the paper's placement spelled out as rules),
``nvfp4-baseline`` (cross-format comparison), ``sensitive-fallback``
(mixed hif4/bf16: the outlier-sensitive down/output projections stay
high-precision — the per-site fallback "Unleashing Low-Bit Inference on
Ascend NPUs" shows 4-bit deployment needs). Policies serialize to JSON
(``to_json_dict``/``from_json_dict``) and ride inside serving artifacts
(``repro.runtime.serve_loop.save_serving_artifact``) so a checkpoint can
never be served under a different placement than it was packed with.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import json
from typing import Optional

import numpy as np

from repro_torch.core.formats import get_format
from repro_torch.core.kvcache import KVCacheConfig
from repro_torch.core.qlinear import QuantConfig, packable_contract_axes


# Block-weight keys eligible for offline PTQ / 4.5-bit packing (the old
# qlinear.PACKABLE_KEYS, now a DEFAULT RULE of policy resolution rather
# than a predicate model code consults). Biases, norms, router and scalar
# state are excluded (paper §IV placement).
PACKABLE_WEIGHT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "wg", "wu", "wi",
    "w_z", "w_x", "w_b", "w_c", "w_dt", "w_out",
})

# Every weight key that is a quantization SITE (a dense()/qbmm call site
# reads its config from the plan). embed is listed for the plan table but
# clamped to fmt='none' at resolution: the embedding lookup is a gather,
# not a matmul (and §IV keeps it high-precision anyway).
SITE_KEYS = PACKABLE_WEIGHT_KEYS | {"router", "embed", "lm_head"}

# The paper-§IV sensitive sites, as patterns. Appended (LAST, so they win)
# by the uniform shim and the presets that follow the paper's placement.
SENSITIVE_SITE_PATTERNS = ("embed", "lm_head", "*.router")

# Stacked-layer collections whose weights can carry offline artifacts
# (QDQ'd bf16 or PackedW). Top-level sites (embed/lm_head) are handled
# separately; hybrid's doubly-stacked blocks never pack (PackedW assumes
# one leading layer axis).
STACKED_COLLECTIONS = ("blocks", "shared", "enc_blocks")


def default_offline_axes(key: str, ndim: int) -> Optional[tuple]:
    """Structural eligibility for offline PTQ/packing of a STACKED block
    weight: the legacy predicate (`key in PACKABLE_KEYS and ndim >= 2`),
    now shared between plan resolution and the legacy
    ``quantize_params_offline`` path so the two can never drift. Returns
    the contraction axes, or None if the key is not a packable weight.
    (The K % 64 gate is shape-dependent and applied by the caller.)
    """
    if key not in PACKABLE_WEIGHT_KEYS or ndim < 2:
        return None
    return packable_contract_axes(key, ndim)


@dataclasses.dataclass(frozen=True)
class QuantRule:
    """One policy rule: sites matching ``pattern`` take the given settings.

    ``None`` fields are inherited from whatever earlier rules (or the
    unquantized default) decided — a rule can flip just ``fmt`` without
    restating ``impl``.
    """

    pattern: str
    fmt: Optional[str] = None
    impl: Optional[str] = None
    weights_only: Optional[bool] = None

    def matches(self, path: str) -> bool:
        return (fnmatch.fnmatchcase(path, self.pattern)
                or fnmatch.fnmatchcase(path, "*." + self.pattern))

    def apply(self, cfg: QuantConfig) -> QuantConfig:
        updates = {}
        if self.fmt is not None:
            updates["fmt"] = self.fmt
        if self.impl is not None:
            updates["impl"] = self.impl
        if self.weights_only is not None:
            updates["weights_only"] = self.weights_only
        return dataclasses.replace(cfg, **updates) if updates else cfg


@dataclasses.dataclass(frozen=True)
class SitePlan:
    """One resolved site: the explicit record of what serving will do.

    packed           : the serving artifact stores this site as 4.5-bit
                       PackedW buffers (and prepare_params_for_serving
                       packs exactly these sites)
    quantize_offline : offline weight PTQ (QDQ along contract_axes) is
                       structurally possible — key is a packable block
                       weight, ndim >= 2, and K is whole 64-groups
    contract_axes    : contraction axes of the (stacked) weight
    """

    path: str
    cfg: QuantConfig
    packed: bool
    quantize_offline: bool
    contract_axes: tuple
    shape: tuple
    n_values: int


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """A policy resolved against one model's param specs.

    ``base`` is the policy evaluated at the attention site — decode
    attention over the (cache-global) packed KV cache dispatches on it,
    and it is what legacy single-config code paths see as "the" config.
    Frozen/hashable: rides into jit cache keys exactly like QuantConfig.
    """

    policy: "QuantPolicy"
    family: str
    base: QuantConfig
    sites: tuple  # tuple[SitePlan, ...]

    @functools.cached_property
    def _by_path(self) -> dict:
        return {s.path: s for s in self.sites}

    def site(self, path: str) -> SitePlan:
        try:
            return self._by_path[path]
        except KeyError:
            raise KeyError(
                f"no quantization site {path!r} in the resolved plan "
                f"(family={self.family!r}; sites: {sorted(self._by_path)})"
            ) from None

    def get(self, path: str) -> Optional[SitePlan]:
        """The SitePlan at ``path``, or None for a non-site leaf (what the
        packing/PTQ walks probe with every param path)."""
        return self._by_path.get(path)

    def at(self, path: str) -> QuantConfig:
        """The resolved QuantConfig a dense() call site executes under."""
        return self.site(path).cfg

    @property
    def kv(self) -> KVCacheConfig:
        return self.policy.kv

    @property
    def packed_paths(self) -> frozenset:
        return frozenset(s.path for s in self.sites if s.packed)

    @property
    def enabled(self) -> bool:
        """Does serving need any artifact conversion at all?"""
        return any(s.packed or s.cfg.enabled for s in self.sites)

    def with_offline_weights(self) -> "QuantPlan":
        """The serving-time plan: every site cfg gets offline_weights=True
        (the blanket flip the legacy serving context applied). Sites whose
        structure admits no offline artifact (e.g. batched-expert weights
        with K not a whole number of 64-groups) therefore serve their
        weights unquantized while activations still quantize — exactly the
        legacy behavior, now visible in the plan instead of implicit.
        """
        flip = lambda c: dataclasses.replace(c, offline_weights=True)
        sites = tuple(dataclasses.replace(s, cfg=flip(s.cfg))
                      for s in self.sites)
        return dataclasses.replace(self, base=flip(self.base), sites=sites)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Ordered per-site quantization rules + the cache-global KV format.

    ``provenance`` records WHERE a policy came from when it was not
    hand-written — the calibration emitter (``repro.calibrate``) stamps
    the search that produced it (arch, calibration set, target budget,
    achieved bytes/value) so a searched policy file is auditable and the
    serving artifact it rides in says how its placement was chosen. It is
    stored as a canonical JSON string (policies are frozen/hashable and
    ride into jit cache keys; a dict field would break that) — read it
    via :meth:`provenance_dict`, attach via :meth:`with_provenance`.
    """

    rules: tuple = ()  # tuple[QuantRule, ...]
    kv: KVCacheConfig = KVCacheConfig()
    name: str = "custom"
    provenance: Optional[str] = None

    def with_provenance(self, meta: dict) -> "QuantPolicy":
        return dataclasses.replace(
            self, provenance=json.dumps(meta, sort_keys=True))

    def provenance_dict(self) -> Optional[dict]:
        return None if self.provenance is None else json.loads(self.provenance)

    @classmethod
    def uniform(cls, cfg: QuantConfig, name: Optional[str] = None
                ) -> "QuantPolicy":
        """Back-compat shim: the policy equivalent of the old global
        config — one catch-all rule plus the §IV exclusions the call
        sites used to hardcode. Bitwise-identical to the pre-policy
        paths on all three impls (tested in tests/test_policy.py).
        """
        rules = (QuantRule("*", fmt=cfg.fmt, impl=cfg.impl,
                           weights_only=cfg.weights_only),)
        rules += tuple(QuantRule(p, fmt="none")
                       for p in SENSITIVE_SITE_PATTERNS)
        return cls(rules=rules, kv=cfg.kv,
                   name=name or f"uniform:{cfg.fmt}")

    def config_at(self, path: str) -> QuantConfig:
        """Fold the rules over one site path (later rules win)."""
        cfg = QuantConfig(fmt="none", impl="qdq", kv=self.kv)
        for rule in self.rules:
            if rule.matches(path):
                cfg = rule.apply(cfg)
        return cfg

    # -- resolution ---------------------------------------------------------

    def resolve(self, specs: dict, family: str) -> QuantPlan:
        """Resolve against a param-spec tree (``lm.abstract_params(cfg)``;
        use ``lm.quant_plan(cfg, policy)`` for the one-liner).

        Site enumeration walks every PSpec leaf whose key is a weight
        site; packing eligibility reproduces the legacy structural rules
        (packable key, ndim >= 2, K a whole number of 64-groups, not a
        batched MoE expert, not hybrid's doubly-stacked blocks) — but the
        DECISION is now ``structural AND the site's resolved config says
        impl packed/pallas on fmt hif4``, so a rule flipping one site to
        bf16 also un-packs exactly that site.
        """
        sites = []
        tied = not any(_leaf_key(k) == "lm_head" for k in specs)

        def walk(node, path_parts):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path_parts + (k,))
                return
            if not hasattr(node, "shape"):
                return
            key = path_parts[-1]
            if key not in SITE_KEYS:
                return
            path = ".".join(path_parts)
            sites.append(self._site(path, key, tuple(node.shape), family))

        walk(specs, ())
        if tied:
            # tied embeddings: lm_logits still queries the "lm_head" site
            # (it contracts embed.T). No separate tensor exists, so no
            # offline artifact — the site is dense-time-QDQ only.
            d_v = next(tuple(s.shape) for k, s in specs.items()
                       if k == "embed")
            sites.append(self._site("lm_head", "lm_head",
                                    (d_v[1], d_v[0]), family,
                                    force_no_offline=True))
        return QuantPlan(policy=self, family=family,
                         base=self.config_at("blocks.attn.wq"),
                         sites=tuple(sorted(sites, key=lambda s: s.path)))

    def _site(self, path: str, key: str, shape: tuple, family: str,
              *, force_no_offline: bool = False) -> SitePlan:
        cfg = self.config_at(path)
        parts = path.split(".")
        in_stacked = parts[0] in STACKED_COLLECTIONS
        under_moe = "moe" in parts[:-1]
        ndim = len(shape)

        ca: tuple = ()
        offline = False
        if in_stacked:
            axes = default_offline_axes(key, ndim)
            if axes is not None:
                ca = axes
                k = int(np.prod([shape[a] for a in ca]))
                offline = k % 64 == 0
        elif key == "lm_head" and ndim == 2 and shape[0] % 64 == 0:
            # top-level untied head: offline QDQ is possible (axis 0)
            ca, offline = (0,), True
        if force_no_offline:
            ca, offline = (), False
        if key == "embed":
            # the embedding lookup is a gather, not a matmul: clamp.
            cfg = dataclasses.replace(cfg, fmt="none")

        packed = (
            offline
            and in_stacked
            and not under_moe          # batched-expert einsum, no packed op
            and family != "hybrid"     # doubly-stacked blocks don't fit
            and cfg.impl in ("packed", "pallas")
            and cfg.fmt == "hif4"      # PackedW is an HiF4 container
        )
        return SitePlan(path=path, cfg=cfg, packed=packed,
                        quantize_offline=offline, contract_axes=ca,
                        shape=shape, n_values=int(np.prod(shape)))

    # -- serialization ------------------------------------------------------

    # every top-level key a policy JSON may carry; from_json_dict rejects
    # anything else loudly (a typo'd "rulse" must not silently yield the
    # default policy)
    JSON_KEYS = frozenset({"name", "kv_format", "rules", "provenance"})
    _RULE_JSON_KEYS = frozenset({"pattern", "fmt", "impl", "weights_only"})

    def to_json_dict(self) -> dict:
        rules = []
        for r in self.rules:
            d = {"pattern": r.pattern}
            if r.fmt is not None:
                d["fmt"] = r.fmt
            if r.impl is not None:
                d["impl"] = r.impl
            if r.weights_only is not None:
                d["weights_only"] = r.weights_only
            rules.append(d)
        out = {"name": self.name, "kv_format": self.kv.kv_format,
               "rules": rules}
        if self.provenance is not None:
            out["provenance"] = json.loads(self.provenance)
        return out

    @classmethod
    def from_json_dict(cls, d: dict) -> "QuantPolicy":
        unknown = set(d) - cls.JSON_KEYS
        if unknown:
            raise ValueError(
                f"policy JSON has unknown top-level key(s) "
                f"{sorted(unknown)} (expected a subset of "
                f"{sorted(cls.JSON_KEYS)}) — a typo here would otherwise "
                f"silently yield the default policy")
        rules = []
        for r in d.get("rules", ()):
            bad = set(r) - cls._RULE_JSON_KEYS
            if bad:
                raise ValueError(
                    f"policy rule {r.get('pattern', r)!r} has unknown "
                    f"key(s) {sorted(bad)} (expected a subset of "
                    f"{sorted(cls._RULE_JSON_KEYS)})")
            rules.append(QuantRule(pattern=r["pattern"], fmt=r.get("fmt"),
                                   impl=r.get("impl"),
                                   weights_only=r.get("weights_only")))
        prov = d.get("provenance")
        return cls(rules=tuple(rules),
                   kv=KVCacheConfig(d.get("kv_format", "bf16")),
                   name=d.get("name", "custom"),
                   provenance=None if prov is None
                   else json.dumps(prov, sort_keys=True))


def _leaf_key(k) -> str:
    return k if isinstance(k, str) else str(k)


@functools.lru_cache(maxsize=None)
def uniform_site_config(quant: QuantConfig, path: str) -> QuantConfig:
    """Per-site config of a plan-less ModelCtx: the uniform shim evaluated
    at ``path``. This is where the old hardcoded NO_QUANT call sites went —
    embed/lm_head/router resolve to fmt='none' through the same rule
    machinery every explicit policy uses.
    """
    cfg = QuantPolicy.uniform(quant).config_at(path)
    return dataclasses.replace(cfg, offline_weights=quant.offline_weights)


# ---------------------------------------------------------------------------
# Preset registry
# ---------------------------------------------------------------------------


def _sensitive_none() -> tuple:
    return tuple(QuantRule(p, fmt="none") for p in SENSITIVE_SITE_PATTERNS)


def _paper_iv(impl: str) -> tuple:
    """§IV placement: HiF4 body, high-precision embed / LM head / router."""
    return (QuantRule("*", fmt="hif4", impl=impl),) + _sensitive_none()


def _nvfp4_baseline(impl: str) -> tuple:
    """Cross-format baseline: NVFP4 (per-tensor-scaled recipe) on the body.
    NVFP4 has no packed container, so no site packs regardless of impl —
    the engine serves it fake-quant (see docs/EXECUTION.md)."""
    return (QuantRule("*", fmt="nvfp4_pts", impl=impl),) + _sensitive_none()


def _sensitive_fallback(impl: str) -> tuple:
    """Mixed hif4/bf16: the outlier-sensitive output/down projections
    (attention wo, MLP down wo) stay bf16 dense while the rest of the body
    packs — the per-site fallback that makes 4-bit deployment robust."""
    return (
        QuantRule("*", fmt="hif4", impl=impl),
        QuantRule("*.attn.wo", fmt="none"),
        QuantRule("*.xattn.wo", fmt="none"),
        QuantRule("*.mlp.wo", fmt="none"),
    ) + _sensitive_none()


PRESETS = {
    "paper-iv": _paper_iv,
    "nvfp4-baseline": _nvfp4_baseline,
    "sensitive-fallback": _sensitive_fallback,
}


def known_policy_spec(spec: str) -> bool:
    """Is ``spec`` a resolvable preset name? (``uniform:<fmt>`` is dynamic
    over the format registry; used by the docs lint.)"""
    if spec in PRESETS:
        return True
    if spec.startswith("uniform:"):
        fmt = spec.split(":", 1)[1]
        if fmt == "none":
            return True
        try:
            get_format(fmt)
        except ValueError:
            return False
        return True
    return False


def get_policy(spec: str, *, impl: str = "packed",
               kv: KVCacheConfig = KVCacheConfig()) -> QuantPolicy:
    """Resolve ``--policy`` spellings: a preset name, ``uniform:<fmt>``,
    or a path to a policy JSON file.

    ``impl``/``kv`` fill in what the spelling leaves unspecified: presets
    take them directly; for a JSON file, ``impl`` is prepended as a base
    catch-all rule (the file's own ``impl`` fields still win — standard
    later-rules-win inheritance) and ``kv`` applies only when the file has
    no ``kv_format`` key. So ``--impl``/``--kv-format`` behave the same
    for file policies as for presets.
    """
    if spec.endswith(".json"):
        with open(spec) as f:
            d = json.load(f)
        pol = QuantPolicy.from_json_dict(d)
        rules = (QuantRule("*", impl=impl),) + pol.rules
        return dataclasses.replace(
            pol, rules=rules,
            kv=pol.kv if "kv_format" in d else kv)
    if spec.startswith("uniform:"):
        fmt = spec.split(":", 1)[1]
        if fmt != "none" and get_format(fmt) is None:
            raise ValueError(f"uniform:{fmt}: unknown format")
        return QuantPolicy.uniform(QuantConfig(fmt=fmt, impl=impl, kv=kv))
    if spec in PRESETS:
        return QuantPolicy(rules=PRESETS[spec](impl), kv=kv, name=spec)
    raise ValueError(
        f"unknown policy {spec!r}: expected a JSON file, 'uniform:<fmt>', "
        f"or one of {sorted(PRESETS)}")
