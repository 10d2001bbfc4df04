from repro_torch.kernels.pack.pack import copy_convert, gather_pack as gather_pack_kernel, segment_table
from repro_torch.kernels.pack.ops import gather_pack, pack_slab, unpack_slab
from repro_torch.kernels.pack.ref import gather_pack_ref, pack_2d_ref, unpack_2d_ref

__all__ = [
    "copy_convert", "gather_pack_kernel", "segment_table",
    "gather_pack", "pack_slab", "unpack_slab",
    "gather_pack_ref", "pack_2d_ref", "unpack_2d_ref",
]
