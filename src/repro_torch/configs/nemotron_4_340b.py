"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.

Features: GQA, squared-ReLU (non-gated) FFN.  [arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        vocab=256000,
        d_ff=73728,
        activation="squared_relu",
        attn=AttnConfig(
            n_heads=96,
            n_kv_heads=8,
            d_head=192,
            rope_theta=10_000.0,
        ),
        source="arXiv:2402.16819; unverified",
    )
)
