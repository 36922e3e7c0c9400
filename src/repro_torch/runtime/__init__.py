"""Serving loop (offline packing, prefill, per-token greedy decode) and the
fault-tolerant train loop."""
from repro_torch.runtime.serve_loop import ServeConfig, serve  # noqa: F401
from repro_torch.runtime.train_loop import TrainLoopConfig, train  # noqa: F401
