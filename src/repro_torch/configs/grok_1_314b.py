"""Grok-1 314B — 8 experts, top-2 routing, the largest assigned arch.

[hf:xai-org/grok-1; unverified] 64L d_model=6144 48H (GQA kv=8) d_ff=32768
(per expert) vocab=131072, MoE 8e top-2.

In bf16 one layer's experts are 16 slots x 3 x 6144 x 16384 weights, about
9.7 GB, and the whole model about 628 GB: more than one 80 GB card holds,
so the port's chip run drives one MoE FFN at full width (``chip_smoke.py``
phase I3), and the training fields (``fsdp_experts``, the bf16 optimizer
state) select nothing until training is ported.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        n_experts=8,
        top_k=2,
        ep_slots=16,
        moe_seq_chunk=0,  # §Perf G1: chunking re-reads expert weights per chunk
        fsdp_experts=True,
        act="geglu",  # gated gelu (GeGLU)
        remat="dots",  # §Perf G4: full-remat recompute is pure compute waste here
        train_microbatches=8,  # §Perf G2: FSDP gather/reduce traffic scales with microbatches
        grad_accum_dtype="bfloat16",
        opt_state_dtype="bfloat16",
        logits_chunk=8192,
    )
)
