"""The production mesh as metadata (PyTorch port of
``src/repro/launch/mesh.py``).

JAX builds a ``Mesh`` of 256 (or 512) devices.  The port has no cluster to
place on, so :func:`make_production_mesh` is a :class:`~repro_torch.core.
mesh.VirtualMesh` of the same axes and sizes on the meta device: the
sharding rules (:mod:`repro_torch.parallel.sharding`) read its axis sizes,
and nothing is ever allocated on it.  Training on such a mesh waits for
ROADMAP Queue 1 item 21.
"""

from __future__ import annotations

import torch

from repro_torch.core.mesh import VirtualMesh


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """16x16 = 256 chips per pod; ``multi_pod`` adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return VirtualMesh(shape, axes, torch.device("meta"))


def data_axes_of(mesh: VirtualMesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)
