"""Cartesian domain decomposition for stencil workloads (PyTorch port).

The port of ``src/repro/stencil/domain.py``.  A :class:`Domain` splits a
global interior across named mesh axes; every rank carries ghost rims of
width ``halo`` on each decomposed axis.  The JAX package *stores* the
decomposed array as one global array of shape :attr:`Domain.stored_global`
(ghosted blocks side by side); the port stores the same blocks stacked,
``(*mesh_shape, *local_ghosted)`` on the mesh's device
(:mod:`repro_torch.core.mesh`).  :func:`stacked_from_stored` and
:func:`stored_from_stacked` convert between the two, which is how the same
state is handed to both packages.

On a mesh that spans processes, a process stores only its own rows,
``(local_size, *local_ghosted)`` in coordinate order.  What takes a whole
array in (:meth:`Domain.from_global_interior`, :meth:`Domain.random`,
:func:`stacked_from_stored`, :func:`reference_exchange`) keeps this
process's rows of it, as JAX's ``make_array_from_callback`` keeps each
process's shards; what gives a whole array out
(:meth:`Domain.to_global_interior`, :func:`stored_from_stacked`) gathers
every process's rows to process 0, which returns the array (the others
return ``None``): a collective every process must call.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core.compat import torch_dtype
from repro_torch.core.halo import HaloSpec
from repro_torch.core.mesh import VirtualMesh


@dataclasses.dataclass(frozen=True)
class Domain:
    """A periodic structured mesh decomposed over ``mesh_axes``
    (``global_interior[i]`` cells along array axis ``i``, decomposed over
    mesh axis ``mesh_axes[i]``, ``None`` = not decomposed).  Its data lives
    on ``mesh.device``."""

    mesh: VirtualMesh
    global_interior: tuple[int, ...]
    mesh_axes: tuple[str | None, ...]
    halo: int = 1
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.global_interior) != len(self.mesh_axes):
            raise ValueError((self.global_interior, self.mesh_axes))
        torch_dtype(self.dtype)
        for size, name in zip(self.global_interior, self.mesh_axes):
            if name is not None:
                procs = self.mesh.shape[name]
                if size % procs:
                    raise ValueError(f"{size} cells do not split over {name}={procs}")
                if size // procs < self.halo:
                    raise ValueError("shard thinner than halo")

    # -- geometry -----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def decomposed(self) -> list[tuple[int, str]]:
        return [(i, name) for i, name in enumerate(self.mesh_axes) if name is not None]

    @property
    def local_interior(self) -> tuple[int, ...]:
        return tuple(
            size // self.mesh.shape[name] if name else size
            for size, name in zip(self.global_interior, self.mesh_axes)
        )

    @property
    def local_ghosted(self) -> tuple[int, ...]:
        return tuple(
            s + (2 * self.halo if name else 0)
            for s, name in zip(self.local_interior, self.mesh_axes)
        )

    @property
    def stored_global(self) -> tuple[int, ...]:
        """Shape of the JAX package's stored (ghost-carrying) global array."""
        return tuple(
            s * self.mesh.shape[name] if name else s
            for s, name in zip(self.local_ghosted, self.mesh_axes)
        )

    @property
    def stacked_shape(self) -> tuple[int, ...]:
        """Shape of this process's stored layout, ``(*mesh_shape,
        *local_ghosted)``, or ``(local_size, *local_ghosted)`` on a grid."""
        return (*self.mesh.stacked_dims, *self.local_ghosted)

    def face_bytes(self) -> dict[str, int]:
        """Per decomposed mesh axis: bytes of one face message (a
        full-extent ghost slab of width ``halo``) of one rank."""
        out = {}
        for axis, name in self.decomposed:
            slab = math.prod(self.halo if a == axis else s
                             for a, s in enumerate(self.local_ghosted))
            out[name] = slab * self.torch_dtype.itemsize
        return out

    def max_face_bytes(self) -> int:
        """Largest single face message: the sweep's message-size coordinate."""
        return max(self.face_bytes().values(), default=0)

    def halo_spec(self, strategy: str = "standard", n_parts: int = 1) -> HaloSpec:
        return HaloSpec(
            mesh_axes=tuple(name for _, name in self.decomposed),
            array_axes=tuple(i for i, _ in self.decomposed),
            halo=self.halo, periodic=True, strategy=strategy, n_parts=n_parts,
        )

    # -- data ---------------------------------------------------------------
    def _as_tensor(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=self.torch_dtype)

    def stored_from_interior(self, interior: np.ndarray) -> np.ndarray:
        """Host-side JAX stored layout of a dense interior (ghosts zero)."""
        if tuple(interior.shape) != self.global_interior:
            raise ValueError(f"interior {interior.shape} != {self.global_interior}")
        h = self.halo
        blocks = interior
        for axis, name in reversed(self.decomposed):
            pieces = np.split(blocks, self.mesh.shape[name], axis=axis)
            widths = [(0, 0)] * blocks.ndim
            widths[axis] = (h, h)
            blocks = np.concatenate([np.pad(p, widths) for p in pieces], axis=axis)
        return np.asarray(blocks, dtype=np.float32 if self.dtype == "bfloat16" else self.dtype)

    def interior_window(self) -> tuple[slice, ...]:
        """Index of the interior cells in the stacked layout."""
        h = self.halo
        return (
            *(slice(None),) * len(self.mesh.stacked_dims),
            *(slice(h, -h) if name else slice(None) for name in self.mesh_axes),
        )

    def from_global_interior(self, interior) -> torch.Tensor:
        """A dense global interior (numpy or tensor) in the stacked layout on
        the domain's device, ghosts zeroed (an exchange fills them)."""
        t = self._as_tensor(interior)
        if tuple(t.shape) != self.global_interior:
            raise ValueError(f"interior {tuple(t.shape)} != {self.global_interior}")
        out = torch.zeros(self.stacked_shape, dtype=self.torch_dtype, device=self.device)
        out[self.interior_window()] = _own_rows(self, _split_to_stacked(self, t, self.local_interior))
        return out

    def to_global_interior(self, x: torch.Tensor) -> np.ndarray | None:
        """Strip ghosts and reassemble the dense global interior (host numpy;
        bf16 comes back as f32, which holds it exactly).  On a grid, every
        process calls it and process 0 gets the array, the others ``None``."""
        x = _gather_stacked(self, x[self.interior_window()])
        if x is None:
            return None
        t = _merge_from_stacked(self, x)
        return t.float().cpu().numpy() if t.dtype == torch.bfloat16 else t.cpu().numpy()

    def random(self, seed: int = 0) -> torch.Tensor:
        """Unit-normal interior drawn on the host from one seeded CPU
        ``torch.Generator``, then uploaded, so one seed gives the same state
        on the card and on the CPU, and a card run of a cell can be compared
        with a CPU run bitwise.  On a grid every process draws the whole
        interior and keeps its own rows, so one seed gives the same state at
        any process count.  Not the JAX package's numpy draw."""
        g = torch.Generator().manual_seed(seed)
        return self.from_global_interior(torch.randn(self.global_interior, generator=g))


# ---------------------------------------------------------------------------
# stored (JAX) <-> stacked (port) layout
# ---------------------------------------------------------------------------


def _split_to_stacked(domain: Domain, t: torch.Tensor, local) -> torch.Tensor:
    """Global array whose decomposed axes are ``k * local[a]`` long ->
    ``(*mesh_shape, *local)`` (ranks along a mesh axis the domain does not
    use hold copies)."""
    dims, mesh_pos, local_pos = [], {}, []
    for a, name in enumerate(domain.mesh_axes):
        if name is not None:
            mesh_pos[name] = len(dims)
            dims.append(domain.mesh.shape[name])
        local_pos.append(len(dims))
        dims.append(local[a])
    t = t.reshape(dims)
    order = []
    for name in domain.mesh.axis_names:
        if name not in mesh_pos:
            t = t.unsqueeze(-1)
            mesh_pos[name] = t.dim() - 1
        order.append(mesh_pos[name])
    t = t.permute(*order, *local_pos)
    return t.expand(*domain.mesh.axis_sizes, *local)


def _own_rows(domain: Domain, x: torch.Tensor) -> torch.Tensor:
    """This process's rows of a whole-mesh ``(*mesh_shape, *local)`` array:
    the array itself in one process, ``(local_size, *local)`` in coordinate
    order on a grid."""
    mesh = domain.mesh
    if mesh.processes == 1:
        return x
    coords = [mesh.coords(c) for c in mesh.local_coords]
    index = tuple(torch.tensor(col, device=x.device) for col in zip(*coords))
    return x[index]


def _gather_stacked(domain: Domain, x: torch.Tensor) -> torch.Tensor | None:
    """The whole-mesh ``(*mesh_shape, *local)`` array from every process's
    rows ``x``: ``x`` itself in one process; on a grid a collective that
    gathers the rows (as bytes, on the host, over ``torch.distributed``) to
    process 0, which gets the array on its CPU; the others get ``None``."""
    mesh = domain.mesh
    if mesh.processes == 1:
        return x
    import torch.distributed as dist

    rows = x.detach().to("cpu", memory_format=torch.contiguous_format)
    wire = rows.reshape(mesh.local_size, -1).view(torch.uint8)
    parts = ([torch.empty_like(wire) for _ in range(mesh.processes)]
             if mesh.process_index == 0 else None)
    dist.gather(wire, parts, dst=0)
    if parts is None:
        return None
    full = torch.empty((mesh.size, *x.shape[1:]), dtype=x.dtype)
    for q, part in enumerate(parts):
        full[list(mesh.coords_of_process(q))] = part.view(x.dtype).view(-1, *x.shape[1:])
    return full.view(*mesh.axis_sizes, *x.shape[1:])


def _merge_from_stacked(domain: Domain, x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_split_to_stacked` (rank 0 of unused mesh axes)."""
    names = list(domain.mesh.axis_names)
    for i in reversed(range(len(names))):
        if names[i] not in domain.mesh_axes:
            x = x.select(i, 0)
            names.pop(i)
    m = len(names)
    order, shape = [], []
    for a, name in enumerate(domain.mesh_axes):
        if name is not None:
            order.append(names.index(name))
        order.append(m + a)
        shape.append(x.shape[m + a] * (domain.mesh.shape[name] if name else 1))
    return x.permute(order).reshape(shape)


def stacked_from_stored(domain: Domain, stored) -> torch.Tensor:
    """JAX stored layout (numpy ``Domain.stored_global``) -> the port's
    stacked layout on the domain's device (this process's rows)."""
    t = domain._as_tensor(stored)
    if tuple(t.shape) != domain.stored_global:
        raise ValueError(f"stored {tuple(t.shape)} != {domain.stored_global}")
    return _own_rows(domain, _split_to_stacked(domain, t, domain.local_ghosted)).contiguous()


def stored_from_stacked(domain: Domain, x: torch.Tensor) -> np.ndarray | None:
    """The port's stacked layout -> the JAX stored layout as host numpy
    (bf16 comes back as f32, which holds it exactly).  On a grid, every
    process calls it and process 0 gets the array, the others ``None``."""
    if tuple(x.shape) != domain.stacked_shape:
        raise ValueError(f"stacked {tuple(x.shape)} != {domain.stacked_shape}")
    x = _gather_stacked(domain, x)
    if x is None:
        return None
    t = _merge_from_stacked(domain, x)
    return t.float().cpu().numpy() if t.dtype == torch.bfloat16 else t.cpu().numpy()


def reference_exchange(domain: Domain, interior) -> torch.Tensor:
    """The exchanged stacked layout, by gather — the correctness oracle.

    Along each decomposed axis (chunk ``c``, halo ``h``) rank ``i`` holds
    global indices ``(i*c - h) .. (i*c + c + h)`` wrapped periodically; the
    whole layout is the tensor product of those per-axis index maps.  Runs
    on the domain's device (the interior may be numpy or a tensor); on a
    grid it gives this process's rows.
    """
    out = domain._as_tensor(interior)
    h = domain.halo
    for axis, name in domain.decomposed:
        k = domain.mesh.shape[name]
        g = out.shape[axis]
        c = g // k
        idx = torch.tensor(
            [(i * c + off - h) % g for i in range(k) for off in range(c + 2 * h)],
            dtype=torch.int64, device=domain.device,
        )
        out = torch.index_select(out, axis, idx)
    return _own_rows(domain, _split_to_stacked(domain, out, domain.local_ghosted)).contiguous()


# ---------------------------------------------------------------------------
# interior/halo region split (the communication/computation-overlap schedule)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UpdateRegion:
    """One piece of an interior/boundary-split stencil update; fields as
    ``repro.stencil.domain.UpdateRegion`` (windows over the local dims)."""

    src: tuple[tuple[int, int], ...]
    out: tuple[tuple[int, int], ...]
    dst: tuple[int, ...]
    needs_fresh_ghosts: bool

    @staticmethod
    def _window(x: torch.Tensor, win) -> torch.Tensor:
        return x[(slice(None), *(slice(s, s + n) for s, n in win))]

    def updated(self, block: torch.Tensor, update_fn) -> torch.Tensor:
        """Run ``update_fn`` on a private copy of this piece's window of
        ``block`` (R, *local); return the validly updated cells."""
        piece = self._window(block, self.src).clone(memory_format=torch.contiguous_format)
        return self._window(update_fn(piece), self.out)


def interior_halo_split(
    shape: tuple[int, ...], array_axes: tuple[int, ...], halo: int
) -> tuple[UpdateRegion, ...]:
    """Split a local ghosted block into overlap-schedulable update pieces:
    the deep interior (computable from the pre-exchange buffer) and one
    ``3*halo``-thick shell per side of each decomposed axis (needs the
    refreshed ghosts).  Same contract and pieces as the JAX function."""
    h = halo
    dec = set(array_axes)
    for a in dec:
        if shape[a] < 3 * h:
            raise ValueError(f"axis {a} of {shape} thinner than 3*halo")
    regions: list[UpdateRegion] = []

    def full(a: int) -> tuple[int, int]:
        return (0, shape[a])

    if all(shape[a] - 4 * h > 0 for a in dec):
        src = tuple((h, shape[a] - 2 * h) if a in dec else full(a) for a in range(len(shape)))
        out = tuple((h, shape[a] - 4 * h) if a in dec else full(a) for a in range(len(shape)))
        dst = tuple(2 * h if a in dec else 0 for a in range(len(shape)))
        regions.append(UpdateRegion(src, out, dst, needs_fresh_ghosts=False))

    for axis in array_axes:
        s = shape[axis]
        for lo in (True, False):
            src = tuple(
                ((0, 3 * h) if lo else (s - 3 * h, 3 * h)) if a == axis else full(a)
                for a in range(len(shape))
            )
            out = tuple(
                (h, h) if a == axis else ((h, shape[a] - 2 * h) if a in dec else full(a))
                for a in range(len(shape))
            )
            dst = tuple(
                ((h if lo else s - 2 * h) if a == axis else (h if a in dec else 0))
                for a in range(len(shape))
            )
            regions.append(UpdateRegion(src, out, dst, needs_fresh_ghosts=True))
    return tuple(regions)


def overlapped_update(
    stale: torch.Tensor,
    fresh: torch.Tensor,
    update_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    array_axes: tuple[int, ...],
    halo: int,
) -> torch.Tensor:
    """Apply ``update_fn`` with the interior/boundary overlap schedule and
    write the result into ``fresh`` (returned); ``stale`` is only read.

    The deep-interior piece reads ``stale`` (the pre-exchange buffer), the
    boundary shells read ``fresh``.  Every piece is computed before any is
    written back, so no piece reads another's output.  Equals
    ``update_fn(fresh)`` under the :func:`interior_halo_split` contract.
    """
    pieces = [
        (region.dst, region.updated(fresh if region.needs_fresh_ghosts else stale, update_fn))
        for region in interior_halo_split(tuple(stale.shape[1:]), array_axes, halo)
    ]
    for dst, piece in pieces:
        fresh[(slice(None), *(slice(d, d + n) for d, n in zip(dst, piece.shape[1:])))] = piece
    return fresh


def periodic_oracle_step(interior: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """NumPy oracle: one 27-point (or 9-point in 2-D) periodic stencil update."""
    pad = np.pad(interior, 1, mode="wrap")
    out = np.zeros_like(interior, dtype=np.float32)
    for offs in itertools.product(*[range(3)] * interior.ndim):
        sl = tuple(slice(o, o + s) for o, s in zip(offs, interior.shape))
        out += weights[offs].astype(np.float32) * pad[sl].astype(np.float32)
    return out.astype(interior.dtype)
