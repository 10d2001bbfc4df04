from repro_torch.kernels.wkv.ops import wkv, wkv_plain
from repro_torch.kernels.wkv.ref import wkv_bwd_plain, wkv_chunked_ref, wkv_scan_ref
from repro_torch.kernels.wkv.wkv import WkvChunkedFn, wkv_chunked, wkv_chunked_bwd

__all__ = ["wkv_chunked", "wkv_chunked_bwd", "WkvChunkedFn", "wkv", "wkv_plain",
           "wkv_chunked_ref", "wkv_scan_ref", "wkv_bwd_plain"]
