"""HuBERT X-Large — encoder-only audio transformer (wav2vec2 architecture).

[arXiv:2106.07447; unverified] 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504 (k-means cluster codebook).  Encoder-only: decode shapes are skipped.
The conv waveform frontend is a STUB: ``input_specs()`` supplies precomputed
frame embeddings of width ``d_vision`` (=512, the conv feature width).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        norm="layernorm",
        act="gelu",
        causal=False,
        audio_frontend_stub=True,
        d_vision=512,  # conv feature-extractor output width (stubbed)
        remat="dots",
        train_microbatches=2,
    )
)
