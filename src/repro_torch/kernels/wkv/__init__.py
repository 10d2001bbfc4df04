from repro_torch.kernels.wkv.ops import wkv, wkv_plain
from repro_torch.kernels.wkv.ref import wkv_chunked_ref, wkv_scan_ref
from repro_torch.kernels.wkv.wkv import wkv_chunked

__all__ = ["wkv_chunked", "wkv", "wkv_plain", "wkv_chunked_ref", "wkv_scan_ref"]
