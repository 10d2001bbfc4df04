# The halo-exchange core of the port:
#   mesh      — virtual mesh (a process's ranks stacked in one tensor)
#   transport — Message tables, packers, the loopback and multihost transports
#   plan      — persistent plans (MPI_Send_init analogue)
#   halo      — N-D ghost-cell exchange schedules
#   partitioned — chunked early-consume collectives (MPI partitioned analogue)
#   ring      — ring attention + recurrent-state passing (LM integrations)
#   model_comm    — analytic LogGP-style model of the paper's measurements
#   comm_analysis — collective counts and wire bytes of a call + roofline terms

from repro_torch.core.compat import resolve_device
from repro_torch.core.mesh import VirtualMesh, make_mesh
from repro_torch.core.transport import (
    Message,
    Packer,
    Partitioner,
    PreparedExchange,
    ScheduleInfo,
    Transport,
    available_packers,
    available_transports,
    get_packer,
    get_transport,
    register_packer,
    register_transport,
)
from repro_torch.core.plan import PLANS, CommPlan, PlanCache
from repro_torch.core.halo import HaloSpec, exchange, exchange_fused, seq_left_halo
from repro_torch.core.partitioned import (
    bucketed_psum_tree,
    partitioned_all_to_all,
    partitioned_ppermute,
    partitioned_psum,
    partitioned_psum_scatter,
    ring_all_gather,
    ring_all_gather_matmul,
    ring_matmul_reduce_scatter,
    ring_perm,
)
from repro_torch.core.ring import ring_attention, state_passing
from repro_torch.core.model_comm import (
    MachineModel,
    StencilWorkload,
    TimeBreakdown,
    simulate,
    speedup,
)
from repro_torch.core.comm_analysis import (
    H100,
    V5E,
    Hardware,
    RooflineTerms,
    count_collectives,
    roofline,
)

__all__ = [
    "resolve_device", "VirtualMesh", "make_mesh",
    "Message", "Packer", "Partitioner", "PreparedExchange", "ScheduleInfo",
    "Transport", "available_packers", "available_transports", "get_packer",
    "get_transport", "register_packer", "register_transport",
    "PLANS", "CommPlan", "PlanCache", "HaloSpec", "exchange", "exchange_fused", "seq_left_halo",
    "partitioned_ppermute", "partitioned_all_to_all", "partitioned_psum",
    "partitioned_psum_scatter", "ring_all_gather", "ring_all_gather_matmul",
    "ring_matmul_reduce_scatter", "bucketed_psum_tree", "ring_perm",
    "ring_attention", "state_passing",
    "MachineModel", "StencilWorkload", "TimeBreakdown", "simulate", "speedup",
    "count_collectives", "roofline", "RooflineTerms", "Hardware", "V5E", "H100",
]
