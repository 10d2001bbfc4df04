"""RWKV-6 (Finch) 1.6B — attention-free, data-dependent decay linear attention.

[arXiv:2404.05892; unverified] 24L d_model=2048 d_ff=7168 vocab=65536.
Sub-quadratic: runs the long_500k cell.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="rwkv6-1.6b",
        family="rwkv",
        n_layers=24,
        d_model=2048,
        d_ff=7168,
        vocab_size=65536,
        rwkv_head_size=64,
        norm="layernorm",
        act="relu",  # channel-mix uses squared relu
        tie_embeddings=False,
        remat="dots",
        scan_chunk=64,  # the JAX package's chunk length for this model
        train_microbatches=2,
        dtype="bfloat16",
    )
)
