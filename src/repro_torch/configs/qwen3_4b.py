"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

Features: qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        vocab=151936,
        d_ff=9728,
        activation="swiglu",
        attn=AttnConfig(
            n_heads=32,
            n_kv_heads=8,
            d_head=128,          # qwen3 uses d_head=128 (not d_model/n_heads)
            qkv_bias=False,
            qk_norm=True,
            rope_theta=1_000_000.0,
        ),
        source="hf:Qwen/Qwen3-8B; hf",
    )
)
