"""Phi-3.5-MoE 42B (6.6B active) — 16 experts, top-2 routing.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 (per expert) vocab=32064, MoE 16e top-2.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        n_experts=16,
        top_k=2,
        ep_slots=16,
        moe_seq_chunk=0,  # §Perf G1 applies here too
        norm="layernorm",
        remat="dots",
        train_microbatches=8,
    )
)
