"""Granite 8B (code) — llama-architecture dense decoder, tied embeddings.

[arXiv:2405.04324; hf] 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        rope_theta=10_000_000.0,
        tie_embeddings=True,
        remat="dots",
        train_microbatches=4,
        logits_chunk=8192,
    )
)
