"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.

Features: QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        vocab=151936,
        d_ff=6912,
        activation="swiglu",
        attn=AttnConfig(
            n_heads=20,
            n_kv_heads=20,
            d_head=128,
            qkv_bias=True,
            rope_theta=1_000_000.0,
        ),
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
)
