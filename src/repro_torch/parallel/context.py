"""Parallel execution context threaded through the port's model code
(PyTorch port of ``src/repro/parallel/context.py``, same fields).

In this slice every model runs on one device: ``mesh`` stays ``None``, and
the model code raises ``NotImplementedError`` where a context asks for a
distributed mode (``seq_parallel`` ring attention, ``tp_mode="ring"``) on a
mesh.  ``use_flash`` is kept for field parity but selects nothing: the
port's local attention takes the CUDA flash kernel for a CUDA tensor and the
plain version for a CPU tensor, whatever the context says.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: Any = None
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str | None = "model"
    # paper technique knobs
    seq_parallel: bool = False  # ring attention / state passing for prefill
    moe_mode: str = "dense"  # dense | ep
    n_parts: int = 1  # partitions per message (1 = fused)
    state_method: str = "ring"  # ring | tree (SSM/RWKV state passing)
    tp_mode: str = "gspmd"  # gspmd | ring
    # transport-layer wire knobs of the message-routed LM comm paths
    comm_packer: str = "slice"
    comm_coalesce: bool = True
    moe_comm: str = "native"  # native | messages
    # numerics: kept for parity with the JAX context; selects nothing here
    use_flash: bool = False


LOCAL = ParallelContext(mesh=None, model_axis=None)
