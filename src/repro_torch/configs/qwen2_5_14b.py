"""Qwen2.5 14B — dense GQA decoder with QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf] 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        remat="dots",
        train_microbatches=8,
        logits_chunk=8192,
    )
)
