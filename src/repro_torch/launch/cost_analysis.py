"""Loop-aware cost model of a step dispatched on the ``meta`` device: the
counterpart of ``repro/launch/hlo_analysis.py``.

The reference parses a compiled XLA executable and multiplies each ``while``
body by its trip count. The port has no graph to parse: :class:`CostMode`, a
``TorchDispatchMode``, costs every aten op a step dispatches on ``meta``
tensors (autograd's backward ops included, so a train step is costed whole),
and nothing is allocated on any device. Per-op model, the reference's
per-instruction one:

  matmul       flops = ``torch.utils.flop_counter``'s formula
                       (2 x result x contraction); bytes = operands + result
  pointwise    flops = result elements; bytes = operands + result
  reduction    flops = operand elements; bytes = operands + result
  data movers  (casts, copies, cat, gather, index, fills) bytes = operands
               + result
  indexed writes in place (``index_put_``, ``scatter_``, ...): twice the
               operands other than the buffer (the reference's in-place
               dynamic-update-slice)
  views        (``view``, ``reshape`` without a copy, ``expand``,
               ``transpose``, ``slice``, ``as_strided``, ``detach``) free

Live bytes: every storage an op creates gets a finalizer, so the mode knows
what is alive after each op; ``peak_live`` is the most the step held beside
its arguments.

Loop-awareness (:func:`extrapolate`): a model's layers repeat, so the step is
costed at a few small depths (from two periods) and every count is fitted as
a polynomial in
the depth (affine for inference; quadratic for a train step, whose stacked
parameters' gradients are rebuilt at full size per layer by autograd's
``select`` backward) and evaluated at the config's depth, as the reference
multiplies a loop body by its trip count. The fit is exact where the count
is such a polynomial, which the tests check against a full-depth dispatch.

What is costed is the route that runs on ``meta``: the plain versions, as the
reference's dry run costs the XLA twins (impl qdq by default). These counts
are no bound for a hand-written kernel, whose bytes and operations are its
own. Nor are ``t_compute_s`` and ``t_memory_s`` a step's roofline: they cost
the plain route's traffic (every f32 flash tile, every pass of the plain
HiF4 attention over the cache), many times the bytes the step must move, so
a share of a benchmark cell's time must not be taken against them. A
roofline counts the function's necessary bytes and operations (weights and
the KV cache read once, activations), as ``chip_smoke.py``'s ``bound_ms``
does for each kernel. A tensor off ``meta`` inside a costed step, or a
kernel launch, raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import weakref
from fractions import Fraction

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import mesh as hw


REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "var", "std", "var_mean", "std_mean", "logsumexp", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "norm", "linalg_vector_norm", "any", "all", "cumsum", "cumprod", "topk",
    "sort", "count_nonzero",
}
# in-place writes through an index: only the written part moves
INDEXED_WRITES = {
    "index_put_", "_index_put_impl_", "index_copy_", "index_add_",
    "scatter_", "scatter_add_", "scatter_reduce_", "index_fill_",
}
# schema says "fresh result", but the result shares its input's storage
VIEW_LIKE = {"_unsafe_view", "lift_fresh", "alias", "detach"}
FILLS = {"fill_", "zero_"}
# tagged pointwise, but they move bytes and compute nothing
COPIES = {"clone", "copy", "copy_", "_to_copy", "lift_fresh_copy"}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)


def _name(func) -> str:
    return func._schema.name.split("::")[-1]


def _classify(func) -> str:
    """view | alloc | func (fresh results) | mut (writes an argument)."""
    name = _name(func)
    schema = func._schema
    if name in VIEW_LIKE:
        return "view"
    if schema.is_mutable:
        return "mut"
    if any(r.alias_info is not None for r in schema.returns):
        return "view"
    if name.startswith("empty") or name == "new_empty" or name == "new_empty_strided":
        return "alloc"
    return "func"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _sig(x):
    """A hashable signature of an op argument; raises off ``meta`` (but for
    an empty tensor, which holds nothing: ``torch.utils.checkpoint``'s
    dummy input)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta and x.numel():
            raise RuntimeError(f"cost model: a {x.device.type} tensor "
                               f"{tuple(x.shape)} inside a costed step (the "
                               f"dry run runs on meta only)")
        return (x.dtype, x.shape, x.stride())
    if isinstance(x, (list, tuple)):
        return tuple([_sig(y) for y in x])
    return x


@dataclasses.dataclass
class Cost:
    """Counts of one dispatch (or of an extrapolation to full depth)."""

    flops: float = 0
    bytes: float = 0
    ops: float = 0
    matmul_flops: float = 0
    peak_live: float = 0            # bytes beside the arguments, at most
    out_live: float = 0             # new bytes the result still holds
    out_alias: float = 0            # argument bytes the result returns
    # the most held beside the arguments while the forward ran, and while
    # autograd's backward ran (peak_live is the larger)
    phase_peaks: dict = dataclasses.field(default_factory=dict)
    # region (the port function that issued the ops) -> [bytes, flops, ops]
    regions: dict = dataclasses.field(default_factory=dict)
    # (region, aten op) -> [bytes, flops, ops]
    region_ops: dict = dataclasses.field(default_factory=dict)

    SCALARS = ("flops", "bytes", "ops", "matmul_flops", "peak_live", "out_live",
               "out_alias")


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes, ops and live bytes of every aten op dispatched
    under it. Functional ops are memoized by signature (dtype, shape,
    stride of every tensor; the other arguments): a repeat gets fresh
    ``meta`` results of the recorded layout without running the meta
    kernel, which is what keeps a full-width cell's tiles cheap."""

    def __init__(self, *, regions: bool = False):
        super().__init__()
        self.cost = Cost()
        self._regions = regions
        self._kind: dict = {}
        self._memo: dict = {}
        self._live: dict = {}       # storage cdata -> nbytes (made in here)
        self._now = 0
        self._mult = 1

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Every op dispatched inside counts ``n`` times (a loop body run
        once for its ``n`` identical iterations)."""
        old = self._mult
        self._mult = old * n
        try:
            yield
        finally:
            self._mult = old

    @contextlib.contextmanager
    def held(self, nbytes: int):
        """``nbytes`` more live while inside (the results of a loop's other
        iterations, which a replay does not make)."""
        self._now += nbytes
        self._peak()
        try:
            yield
        finally:
            self._now -= nbytes

    def add(self, cost: "Cost", n: int) -> None:
        """Count ``cost`` (another mode's) ``n`` times."""
        for name in ("flops", "bytes", "ops", "matmul_flops"):
            setattr(self.cost, name, getattr(self.cost, name)
                    + getattr(cost, name) * n)
        for table in ("regions", "region_ops"):
            dst = getattr(self.cost, table)
            for key, row in getattr(cost, table).items():
                d = dst.setdefault(key, [0, 0, 0])
                for i in range(3):
                    d[i] += row[i] * n

    # -- live bytes ----------------------------------------------------------

    def _free(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self._now -= nbytes

    def _track(self, out, args) -> None:
        arg_storages = None
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            if arg_storages is None:
                arg_storages = {a.untyped_storage()._cdata for a in _tensors(args)}
            if key in arg_storages:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._now += n
            weakref.finalize(st, self._free, key, n)
        self._peak()

    def _peak(self) -> None:
        phase = ("backward" if torch._C._current_graph_task_id() != -1
                 else "forward")
        peaks = self.cost.phase_peaks
        if self._now > peaks.get(phase, 0):
            peaks[phase] = self._now
            self.cost.peak_live = max(self.cost.peak_live, self._now)

    def live_bytes_of(self, tree) -> int:
        """Bytes of the storages in ``tree`` that were made under the mode."""
        seen = {}
        for t in _tensors(tree):
            key = t.untyped_storage()._cdata
            if key in self._live:
                seen[key] = self._live[key]
        return sum(seen.values())

    # -- per-op cost ---------------------------------------------------------

    def _op_cost(self, func, kind, args, kwargs, out) -> tuple:
        """(flops, bytes, matmul flops) of one op."""
        name = _name(func)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        if kind == "alloc":
            return 0, 0, 0
        if kind == "mut" and name in FILLS:
            return 0, sum(_nbytes(t) for t in outs), 0
        if kind == "mut" and name in INDEXED_WRITES:
            rest = sum(_nbytes(t) for t in ins[1:])
            return 0, 2 * rest, 0
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        packet = func._overloadpacket
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            return f, nbytes, f
        if torch.Tag.pointwise in func.tags and name not in COPIES:
            return sum(t.numel() for t in outs), nbytes, 0
        if name in REDUCTIONS:
            return (ins[0].numel() if ins else 0), nbytes, 0
        return 0, nbytes, 0

    def _region(self) -> str:
        """The innermost function of the port below the dispatch."""
        f = sys._getframe(2)
        while f is not None:
            fn = f.f_code.co_filename
            if fn.startswith(_PKG) and fn != _HERE:
                mod = os.path.relpath(fn, _PKG)[:-3].replace(os.sep, ".")
                return f"{mod}.{f.f_code.co_name}"
            f = f.f_back
        return "(outside the port)"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kind.get(func)
        if kind is None:
            kind = self._kind[func] = _classify(func)
        c = self.cost
        n = self._mult
        c.ops += n
        if kind == "view":          # a view of a tensor off meta raises at
            out = func(*args, **kwargs)   # the first op that reads it
            if self._regions:
                self._add_region(func, 0, 0, n)
            return out
        key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
        hit = self._memo.get(key)
        if hit is not None and kind != "mut":
            flops, nbytes, mm, layout = hit
            outs = [torch.empty_strided(shape, stride, dtype=dt, device="meta")
                    for dt, shape, stride in layout[1]]
            out = outs[0] if layout[0] else tuple(outs)
        else:
            out = func(*args, **kwargs)
            if hit is not None:
                flops, nbytes, mm = hit[:3]
            else:
                flops, nbytes, mm = self._op_cost(func, kind, args, kwargs, out)
                for t in _tensors(out):
                    _sig(t)
                layout = None
                single = isinstance(out, torch.Tensor)
                if kind != "mut" and (single or (
                        isinstance(out, (tuple, list)) and out
                        and all(isinstance(t, torch.Tensor) for t in out))):
                    layout = (single, [(t.dtype, tuple(t.shape), t.stride())
                                       for t in ([out] if single else out)])
                if kind == "mut" or layout is not None:
                    self._memo[key] = (flops, nbytes, mm, layout)
        c.flops += flops * n
        c.bytes += nbytes * n
        c.matmul_flops += mm * n
        if kind != "mut":
            self._track(out, (args, kwargs))
        if self._regions:
            self._add_region(func, nbytes, flops, n)
        return out

    def _add_region(self, func, nbytes, flops, n) -> None:
        r = self._region()
        for table, key in ((self.cost.regions, r),
                           (self.cost.region_ops, (r, str(func)))):
            row = table.setdefault(key, [0, 0, 0])
            row[0] += nbytes * n
            row[1] += flops * n
            row[2] += n


def _closure_tensors(fn) -> list:
    """The tensors a chunk function closes over that autograd records (the
    layer's weights): where a chunk's gradients leave the chunk."""
    found: dict = {}

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.requires_grad:
                found[id(v)] = v
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    for cell in fn.__closure__ or ():
        walk(cell.cell_contents)
    return list(found.values())


class _Replayed(torch.autograd.Function):
    """The output of a replayed chunk loop where autograd records it. The
    backward counts what the loop's own backward does: each chunk's
    backward (one chunk's, measured, times the chunk count), the sum of the
    chunks' contributions to each weight, the cat of the chunks' input
    gradients; and hands those gradients on."""

    @staticmethod
    def forward(ctx, xp, loop, *weights):
        # loop: [k, axis, rows, mode, y, chunk] (in a list, so autograd
        # does not take y or the chunk for inputs of this node)
        ctx.loop = loop + [weights]
        k, axis, y = loop[0], loop[1], loop[4]
        return torch.cat([y.detach()] * k, dim=axis)

    @staticmethod
    def backward(ctx, g):
        k, axis, rows, mode, y, chunk, weights = ctx.loop
        del ctx.loop
        with mode.repeat(k):
            g.narrow(axis, 0, rows)            # the cat's backward, per chunk
        inputs = ([chunk] if chunk.requires_grad else []) + list(weights)
        sub = CostMode(regions=mode._regions)
        with _disable_current_modes():
            g0 = torch.empty_like(y)
            with sub:
                grads = torch.autograd.grad(y, inputs, g0, allow_unused=True)
        mode.add(sub.cost, k)
        grads = list(grads)
        gx = grads.pop(0) if chunk.requires_grad else None
        for gl in grads:
            if gl is not None:
                with mode.repeat(k - 1):       # the chunks' sum at the weight
                    torch.add(gl, gl)
        if gx is not None:
            gx = torch.cat([gx] * k, dim=axis)
        return (gx, None, *grads)


def _replayed_row_chunks(mode: CostMode):
    """``engine.in_row_chunks`` with its loop costed once and counted for
    every chunk: the chunks are of one shape, so each costs the same (the
    MoE layer's router and expert products run 32 rows at a time, tens of
    thousands of chunks a layer at the assignment's shapes). Exact where
    nothing is recorded (tested against the loop); under autograd the
    backward is one chunk's times the count (:class:`_Replayed`), which
    skips the zero gradients the split's backward makes for the chunks a
    replay never ran."""
    def in_row_chunks(fn, x, rows, axis=0):
        n = x.shape[axis]
        pad = list(x.shape)
        pad[axis] = -n % rows
        x = torch.cat([x, x.new_zeros(pad)], dim=axis)
        chunks = x.split(rows, dim=axis)
        k = len(chunks)
        weights = _closure_tensors(fn) if torch.is_grad_enabled() else []
        if not weights and not x.requires_grad:
            with mode.repeat(k):
                y = fn(chunks[0].contiguous())
            with mode.held((k - 1) * _nbytes(y)):
                out = torch.cat([y] * k, dim=axis)
            return out.narrow(axis, 0, n)
        # the chunk cut from the graph: its backward ends at the chunk and
        # at the weights, as one chunk's does in the loop
        chunk = chunks[0].detach().requires_grad_(x.requires_grad)
        with mode.repeat(k), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            y = fn(chunk.contiguous())
        with mode.held((k - 1) * _nbytes(y)):
            out = _Replayed.apply(x, [k, axis, rows, mode, y, chunk], *weights)
        return out.narrow(axis, 0, n)

    return in_row_chunks


def count(fn, *args, regions: bool = False, replay_chunks: bool = True,
          **kwargs) -> tuple:
    """(result, :class:`Cost`) of ``fn(*args, **kwargs)`` under a
    :class:`CostMode`; ``replay_chunks`` costs ``engine.in_row_chunks``'s
    loop once per call. The kernel launch counters must not move."""
    from unittest import mock

    from repro_torch.core import engine
    from repro_torch.kernels import build

    before = dict(build.LAUNCHES)
    mode = CostMode(regions=regions)
    patch = (mock.patch.object(engine, "in_row_chunks",
                               _replayed_row_chunks(mode))
             if replay_chunks else contextlib.nullcontext())
    with patch, mode:
        out = fn(*args, **kwargs)
    if build.LAUNCHES != before:
        raise RuntimeError(f"cost model: a kernel was launched inside a "
                           f"costed step ({before} -> {build.LAUNCHES})")
    mode.cost.out_live = mode.live_bytes_of(out)
    mode.cost.out_alias = _storage_bytes(out, _tensors((args, kwargs)))
    return out, mode.cost


def _storage_bytes(tree, among: list) -> int:
    """Bytes of the distinct storages of ``tree`` that ``among`` holds."""
    pool = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in among}
    return sum(pool[k] for k in {t.untyped_storage()._cdata
                                 for t in _tensors(tree)} if k in pool)


# ---------------------------------------------------------------------------
# Loop-aware extrapolation
# ---------------------------------------------------------------------------


def _features(knobs: tuple, degree: int) -> list:
    row = [Fraction(1)]
    for d in range(1, degree + 1):
        row += [Fraction(k) ** d for k in knobs]
    return row


def _solve(a: list, b: list) -> list:
    """Exact Gaussian elimination over the rationals (a square)."""
    n = len(a)
    m = [row[:] + [rhs] for row, rhs in zip(a, b)]
    for col in range(n):
        piv = next(r for r in range(col, n) if m[r][col] != 0)
        m[col], m[piv] = m[piv], m[col]
        for r in range(n):
            if r != col and m[r][col] != 0:
                f = m[r][col] / m[col][col]
                m[r] = [x - f * y for x, y in zip(m[r], m[col])]
    return [m[i][n] / m[i][i] for i in range(n)]


def sample_points(n_knobs: int, degree: int) -> list:
    """The knob settings to cost: all at two periods, then each knob at
    3 .. 2 + degree. Not from one period: a one-period step's peak is not
    yet on the line the deeper ones lie on."""
    pts = [(2,) * n_knobs]
    for i in range(n_knobs):
        for v in range(3, degree + 3):
            pts.append(tuple(v if j == i else 2 for j in range(n_knobs)))
    return pts


def extrapolate(samples: list, target: tuple, degree: int) -> tuple:
    """``samples`` [(knobs, Cost)] at :func:`sample_points` -> (the Cost at
    ``target``, per-region multiplicity). Every scalar and every region
    entry is fitted exactly as a polynomial of ``degree`` in each knob (no
    cross terms) and evaluated at ``target``."""
    a = [_features(k, degree) for k, _ in samples]
    fa = _features(target, degree)

    def fit(values: list) -> float:
        coef = _solve(a, [Fraction(v) for v in values])
        return sum(c * f for c, f in zip(coef, fa))

    def at(value) -> int:
        v = fit(value)
        return int(v) if v.denominator == 1 else float(v)

    out = Cost()
    for name in Cost.SCALARS:
        setattr(out, name, at([getattr(c, name) for _, c in samples]))
    # the peak: each phase's line, then the larger (the two lines may cross
    # beyond the sampled depths). Within a phase the peak may still be the
    # larger of two lines: with two knobs (audio), AdamW's per-leaf
    # temporaries peak at the larger of the encoder's and the decoder's
    # stacked leaves, which no additive fit follows (an over-estimate)
    phases = {p for _, c in samples for p in c.phase_peaks}
    out.phase_peaks = {p: at([c.phase_peaks.get(p, 0) for _, c in samples])
                       for p in phases}
    if phases:
        out.peak_live = max(out.phase_peaks.values())
    mult = {}
    for table in ("regions", "region_ops"):
        keys = set()
        for _, c in samples:
            keys.update(getattr(c, table))
        dst = getattr(out, table)
        for key in keys:
            rows = [getattr(c, table).get(key, [0, 0, 0]) for _, c in samples]
            dst[key] = [at([r[i] for r in rows]) for i in range(3)]
            if table == "regions":
                # the knobs this region's ops grow with: its multiplicity
                grows = [i for i in range(len(target))
                         if rows[1 + i * degree][2] != rows[0][2]]
                mult[key] = max((target[i] for i in grows), default=1)
    return out, mult


# ---------------------------------------------------------------------------
# Roofline terms and memory (the reference's record fields)
# ---------------------------------------------------------------------------


def analyze(cost: Cost) -> dict:
    """Roofline terms on the card (seconds) and the raw counters: the plain
    route's traffic over the card's bf16 peak and HBM rate (see the module's
    docstring: no roofline's denominator)."""
    t_compute = cost.flops / hw.PEAK_FLOPS_BF16
    t_memory = cost.bytes / hw.HBM_BW
    dominant = "compute" if t_compute >= t_memory else "memory"
    return {
        "flops_per_device": cost.flops,
        "matmul_flops_per_device": cost.matmul_flops,
        "bytes_per_device": cost.bytes,
        "wire_bytes_per_device": 0,
        "collective_ops": {},
        "aten_ops": cost.ops,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": 0.0,
        "dominant": dominant,
    }


def memory_stats(cost: Cost, argument_bytes: int) -> dict:
    """The reference's memory fields: ``output_bytes`` the result's bytes
    (made in the step, plus the arguments it returns, as the in-place
    cache: ``alias_bytes``), ``temp_bytes`` the rest of the peak, and
    ``peak_bytes_est`` = arguments + the most the step held beside them."""
    alias_bytes = int(cost.out_alias)
    out = int(cost.out_live) + alias_bytes
    peak_new = int(cost.peak_live)
    return {
        "argument_bytes": int(argument_bytes),
        "output_bytes": out,
        "temp_bytes": max(peak_new - int(cost.out_live), 0),
        "alias_bytes": int(alias_bytes),
        "peak_bytes_est": int(argument_bytes) + peak_new,
    }
