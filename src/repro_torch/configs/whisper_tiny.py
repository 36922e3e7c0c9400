"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.

Encoder-decoder; the conv frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (batch, frames,
d_model) for the encoder. Decoder shapes follow the LM shape set with
seq_len interpreted as encoder frames (prefill) / decoder KV length
(decode).  [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,                 # decoder layers
        enc_layers=4,               # encoder layers
        d_model=384,
        vocab=51865,
        d_ff=1536,
        activation="gelu",
        attn=AttnConfig(
            n_heads=6,
            n_kv_heads=6,
            d_head=64,
            rope_theta=10_000.0,    # whisper uses learned/sinusoidal pos; we use RoPE-free sinusoidal
        ),
        embeds_input=True,
        source="arXiv:2212.04356; unverified",
    )
)
