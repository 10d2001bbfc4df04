"""StableLM-2 1.6B — dense MHA decoder (kv=32), LayerNorm, partial rotary.

[hf:stabilityai/stablelm-2-1_6b; unverified] 24L d_model=2048 32H (GQA kv=32)
d_ff=5632 vocab=100352.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
        norm="layernorm",
        rope_pct=0.25,
        remat="none",
        train_microbatches=2,
        logits_chunk=8192,
    )
)
