"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000.

The anyres-tiling vision frontend is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings of shape
(batch, seq, d_model); the framework runs the language backbone on them.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        vocab=64000,
        d_ff=20480,
        activation="swiglu",
        attn=AttnConfig(
            n_heads=56,
            n_kv_heads=8,
            d_head=128,
            rope_theta=5_000_000.0,
        ),
        embeds_input=True,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    )
)
