from repro_torch.kernels.flash_attention.flash import flash_attention
from repro_torch.kernels.flash_attention.ops import attention, attention_plain
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "attention", "attention_plain", "attention_ref"]
