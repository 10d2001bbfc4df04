"""Architecture registry of the PyTorch port: importing this package
registers the architectures whose models are ported: the dense decoders
that ``repro_torch.models.transformer`` runs, the RWKV-6 model of
``repro_torch.models.rwkv`` and the MoE decoders of
``repro_torch.models.moe`` (the other families of the JAX package's
registry wait for their slice)."""

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
    llama3_8b,
    phi3_5_moe_42b,
    qwen2_5_14b,
    rwkv6_1_6b,
    stablelm_1_6b,
)
