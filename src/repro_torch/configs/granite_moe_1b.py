"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        vocab=49155,
        d_ff=512,
        activation="swiglu",
        attn=AttnConfig(
            n_heads=16,
            n_kv_heads=8,
            d_head=64,
            rope_theta=10_000.0,
        ),
        moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    )
)
