"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        vocab=50280,
        d_ff=0,                     # attention-free, no FFN (Mamba block only)
        ssm=SSMConfig(
            d_state=128,
            expand=2,
            head_dim=64,
            n_groups=1,
            conv_kernel=4,
            chunk=256,
        ),
        tie_embeddings=True,
        source="arXiv:2405.21060; unverified",
    )
)
