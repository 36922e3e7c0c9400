"""PyTorch/CUDA port of the HiF4 serving system (``src/repro`` is the JAX
reference it is held against).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a machine without a CUDA device they raise instead of falling back.
Hand-written Hopper kernels live in ``csrc/`` and are built on first use
(:mod:`repro_torch.kernels.build`).
"""
