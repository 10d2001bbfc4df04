# The halo-exchange core of the port:
#   mesh      — virtual mesh (a process's ranks stacked in one tensor)
#   transport — Message tables, packers, the loopback and multihost transports
#   plan      — persistent plans (MPI_Send_init analogue)
#   halo      — N-D ghost-cell exchange schedules

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
from repro_torch.core.halo import HaloSpec, exchange, exchange_fused

__all__ = [
    "resolve_device", "VirtualMesh", "make_mesh",
    "Message", "Packer", "Partitioner", "PreparedExchange", "ScheduleInfo",
    "Transport", "available_packers", "available_transports", "get_packer",
    "get_transport", "register_packer", "register_transport",
    "PLANS", "CommPlan", "PlanCache", "HaloSpec", "exchange", "exchange_fused",
]
