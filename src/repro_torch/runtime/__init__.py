"""Serving loop: offline packing, prefill, per-token greedy decode."""
from repro_torch.runtime.serve_loop import ServeConfig, serve  # noqa: F401
