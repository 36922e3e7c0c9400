"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention blocks.

We follow the Zamba2 scheme at the granularity this framework models: 54
Mamba2 layers with ONE shared full transformer block (attention + FFN)
invoked every ``hybrid_attn_every`` layers, each invocation keeping its own
KV cache. (Zamba2's per-invocation LoRA deltas on the shared block are
omitted — noted in DESIGN.md.)  [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, SSMConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        vocab=32000,
        d_ff=10240,
        activation="gelu",
        attn=AttnConfig(
            n_heads=32,
            n_kv_heads=32,
            d_head=80,
            rope_theta=10_000.0,
        ),
        ssm=SSMConfig(
            d_state=64,
            expand=2,
            head_dim=64,
            n_groups=1,
            conv_kernel=4,
            chunk=256,
        ),
        hybrid_attn_every=6,
        source="arXiv:2411.15242; hf",
    )
)
