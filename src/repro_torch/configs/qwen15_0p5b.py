"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.

Features: QKV bias (MHA: kv == heads).  [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        vocab=151936,
        d_ff=2816,
        activation="swiglu",
        attn=AttnConfig(
            n_heads=16,
            n_kv_heads=16,
            d_head=64,
            qkv_bias=True,
            rope_theta=1_000_000.0,
        ),
        tie_embeddings=True,
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
)
