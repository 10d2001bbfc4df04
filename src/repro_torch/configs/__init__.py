"""Architecture registry of the PyTorch port: importing this package
registers every architecture of the JAX package's registry: the dense
decoders that ``repro_torch.models.transformer`` runs, the RWKV-6 model of
``repro_torch.models.rwkv``, the MoE decoders of ``repro_torch.models.moe``,
the zamba2 hybrid of ``repro_torch.models.hybrid``, the llama-3.2-vision
decoder of ``repro_torch.models.vision`` and the hubert encoder of
``repro_torch.models.encoder``."""

from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    get_config,
    register,
)

# one module per architecture (imports register into the registry)
from repro_torch.configs import (  # noqa: F401
    granite_8b,
    grok_1_314b,
    hubert_xlarge,
    llama3_8b,
    llama_3_2_vision_11b,
    phi3_5_moe_42b,
    qwen2_5_14b,
    rwkv6_1_6b,
    stablelm_1_6b,
    zamba2_1_2b,
)
