"""Zamba2 1.2B — Mamba2 backbone + shared attention block every 6 layers.

[arXiv:2411.15242; hf] 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Hybrid/sub-quadratic: runs the long_500k cell.  The shared
transformer block (one set of weights) is applied every ``attn_every`` mamba
blocks — the most literal halo/stencil analogue in the pool (conv1d ghost
cells + SSD state ring across sequence shards).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_heads=64,  # d_inner / 64 head_dim
        ssm_expand=2,
        conv_kernel=4,
        attn_every=6,
        remat="dots",
        train_microbatches=2,
    )
)
