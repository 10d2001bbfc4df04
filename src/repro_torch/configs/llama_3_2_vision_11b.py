"""Llama 3.2 Vision 11B — text decoder with gated cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256.  8 of the 40 layers are cross-attention layers (every
5th, HF layout).  The vision tower is a STUB: ``input_specs()`` supplies
precomputed patch embeddings of width ``d_vision``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        n_cross_layers=8,
        cross_every=5,
        vision_tokens=1601,
        d_vision=1280,
        remat="dots",
        train_microbatches=8,
        logits_chunk=8192,
    )
)
