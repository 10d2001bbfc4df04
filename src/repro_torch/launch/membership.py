"""Coordinator-led membership for elastic grids: JOIN, loss, epochs
(PyTorch port of ``src/repro/launch/membership.py``, pure Python).

A relaunch after a rank loss makes every survivor pay plan setup again
(on the card: a CUDA graph capture and its pool), the cost persistent
communication exists to amortize.  This tiny service, run by the
coordinator (rank 0), lets the grid re-form *around* the survivors:

``epoch``
    A monotone counter naming one composition of the grid.  Formation is
    epoch 0; every JOIN and every detected loss bumps it.  The epoch is
    stamped into :class:`~repro_torch.core.halo.HaloSpec` /
    :class:`~repro_torch.core.transport.ScheduleInfo` (``tag()`` suffix
    ``!e<epoch>``) and so into every persistent plan key:
    :meth:`~repro_torch.core.plan.PlanCache.invalidate_stale_epochs` drops
    exactly the plans of a dead composition and leaves every other warm.

JOIN
    A new worker registers mid-run; the coordinator admits it, bumps the
    epoch and announces the new member set; survivors grow the mesh and
    move *live* state onto it through
    :func:`repro_torch.train.fault_tolerance.reshard_state`.

in-grid LOSS recovery
    Workers heartbeat each step.  A rank that misses the window is
    declared lost, the epoch bumps, and the survivors barrier on the new
    epoch (:meth:`MembershipService.ack`) before re-initializing on the
    shrunken set.  Only when the coordinator itself dies
    (:class:`CoordinatorLost`) does recovery fall back to a relaunch.

The state machine is transport-free (drive it in process with a fake
clock); :class:`MembershipServer` / :class:`MembershipClient` put it behind
a JSON-per-line TCP socket advertised through ``REPRO_TORCH_MEMBERSHIP``,
the port's own variable beside the other ``REPRO_TORCH_*`` grid variables
(:mod:`repro_torch.launch.stencil`): a JAX worker (``REPRO_MEMBERSHIP``)
and a port worker never join each other's service.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import socketserver
import threading
import time
from typing import Callable

from repro_torch.train.fault_tolerance import EpochBump, HeartbeatLedger

__all__ = [
    "MEMBERSHIP_VAR",
    "CoordinatorLost",
    "MemberView",
    "MembershipService",
    "MembershipServer",
    "MembershipClient",
    "membership_env",
    "serve_from_env",
    "client_from_env",
]

#: env var carrying the coordinator's membership endpoint ("host:port"),
#: stamped next to REPRO_TORCH_COORDINATOR by
#: :func:`repro_torch.launch.stencil.worker_env`
MEMBERSHIP_VAR = "REPRO_TORCH_MEMBERSHIP"


class CoordinatorLost(RuntimeError):
    """The membership coordinator is unreachable or has declared itself
    dead.  In-grid recovery is impossible without it: callers fall back
    to the relaunch path."""


@dataclasses.dataclass(frozen=True)
class MemberView:
    """One stable composition of the grid, as the coordinator announces it.

    ``cause`` records why this epoch exists: ``"form"`` (initial seal),
    ``"join"`` (a rank registered mid-run), or ``"loss"`` (missed
    heartbeats).  Everything a worker needs to re-form — who is in, and
    under which epoch its new plans must be stamped — is here.
    """

    epoch: int
    members: tuple[int, ...]
    cause: str = "form"

    def to_wire(self) -> dict:
        return {"epoch": self.epoch, "members": list(self.members),
                "cause": self.cause}

    @staticmethod
    def from_wire(d: dict) -> "MemberView":
        return MemberView(epoch=int(d["epoch"]),
                          members=tuple(int(r) for r in d["members"]),
                          cause=str(d["cause"]))


class MembershipService:
    """The coordinator-side state machine (transport-free).

    Lifecycle: workers :meth:`register` during formation, the coordinator
    :meth:`seal`\\ s the founding set at epoch 0, then workers
    :meth:`heartbeat` every step.  After the seal, :meth:`register` is a
    JOIN (epoch bump, ``cause="join"``); :meth:`detect_losses` +
    :meth:`mark_lost` is the loss path (epoch bump, ``cause="loss"``).
    Each bump opens a barrier: survivors :meth:`ack` the new epoch and
    poll :meth:`barrier_complete` before touching the re-formed mesh, so
    no rank runs ahead into a composition its peers have not adopted.

    ``clock`` is injectable so heartbeat-timeout tests never sleep.
    """

    def __init__(self, *, heartbeat_timeout: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 start_epoch: int = 0):
        self._lock = threading.Lock()
        self._clock = clock
        self.heartbeat_timeout = float(heartbeat_timeout)
        self._ledger = HeartbeatLedger(timeout=heartbeat_timeout)
        # a replacement coordinator (after CoordinatorLost -> relaunch)
        # seeds start_epoch past its predecessor's last bump, keeping plan
        # staleness monotone across the coordinator generation change
        self._epoch = EpochBump(epoch=start_epoch, cause="form")
        self._sealed = False
        self._alive = True
        self._acked: set[int] = set()

    # -- introspection ------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self._alive

    @property
    def view(self) -> MemberView:
        with self._lock:
            return self._view_locked()

    def _view_locked(self) -> MemberView:
        return MemberView(epoch=self._epoch.epoch,
                          members=self._ledger.ranks,
                          cause=self._epoch.cause)

    def _check_alive(self) -> None:
        if not self._alive:
            raise CoordinatorLost("membership coordinator is down")

    # -- formation & JOIN ---------------------------------------------------
    def register(self, rank: int) -> MemberView:
        """Admit ``rank``.  Before :meth:`seal` this is formation (no
        epoch bump); after it, it is a JOIN and the epoch advances."""
        self._check_alive()
        with self._lock:
            joined_late = self._sealed and rank not in self._ledger
            self._ledger.beat(rank, self._clock())
            if joined_late:
                self._bump_locked("join")
            return self._view_locked()

    def seal(self) -> MemberView:
        """Formation complete: the current member set is epoch 0."""
        self._check_alive()
        with self._lock:
            self._sealed = True
            return self._view_locked()

    # -- heartbeats & LOSS --------------------------------------------------
    def heartbeat(self, rank: int, step: int | None = None) -> MemberView:
        """Record a beat and return the current view — the worker learns
        of any epoch bump from the return value, no push channel needed."""
        self._check_alive()
        with self._lock:
            if rank in self._ledger:
                self._ledger.beat(rank, self._clock(), step=step)
            return self._view_locked()

    def detect_losses(self) -> tuple[int, ...]:
        """Ranks whose last beat is older than the heartbeat window."""
        self._check_alive()
        now = self._clock()
        with self._lock:
            return self._ledger.missing(now)

    def mark_lost(self, *ranks: int) -> MemberView:
        """Evict ``ranks`` and bump the epoch (``cause="loss"``)."""
        self._check_alive()
        with self._lock:
            evicted = False
            for r in ranks:
                evicted = self._ledger.evict(r) or evicted
            if evicted:
                self._bump_locked("loss")
            return self._view_locked()

    def _bump_locked(self, cause: str) -> None:
        self._epoch = EpochBump(epoch=self._epoch.epoch + 1, cause=cause)
        self._acked.clear()  # each epoch opens a fresh barrier

    # -- coordinator-led barrier -------------------------------------------
    def ack(self, rank: int, epoch: int) -> MemberView:
        """Survivor ``rank`` has adopted ``epoch`` (stale plans dropped,
        mesh re-formed).  Acks for a superseded epoch are ignored."""
        self._check_alive()
        with self._lock:
            if epoch == self._epoch.epoch and rank in self._ledger:
                self._acked.add(rank)
            return self._view_locked()

    def barrier_complete(self, epoch: int) -> bool:
        """True once every current member has acked ``epoch``."""
        self._check_alive()
        with self._lock:
            return (epoch == self._epoch.epoch
                    and self._acked >= set(self._ledger.ranks))

    # -- chaos --------------------------------------------------------------
    def fail(self) -> None:
        """Kill the coordinator (chaos hook): every subsequent call
        raises :class:`CoordinatorLost`, which is the relaunch-fallback
        trigger."""
        self._alive = False


# ---------------------------------------------------------------------------
# TCP wire: JSON-per-line request/response over the REPRO_TORCH_* env protocol
# ---------------------------------------------------------------------------

_OPS = {
    "register": lambda svc, req: svc.register(int(req["rank"])).to_wire(),
    "seal": lambda svc, req: svc.seal().to_wire(),
    "heartbeat": lambda svc, req: svc.heartbeat(
        int(req["rank"]), req.get("step")).to_wire(),
    "view": lambda svc, req: svc.view.to_wire(),
    "detect": lambda svc, req: {"lost": list(svc.detect_losses())},
    "mark_lost": lambda svc, req: svc.mark_lost(
        *[int(r) for r in req["ranks"]]).to_wire(),
    "ack": lambda svc, req: svc.ack(
        int(req["rank"]), int(req["epoch"])).to_wire(),
    "barrier": lambda svc, req: {
        "complete": svc.barrier_complete(int(req["epoch"]))},
}


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        line = self.rfile.readline()
        if not line:
            return
        svc = self.server.service  # type: ignore[attr-defined]
        req = json.loads(line.decode("utf-8"))
        try:
            body = _OPS[req["op"]](svc, req)
            resp = {"ok": True, **body}
        except CoordinatorLost as e:
            resp = {"ok": False, "error": "coordinator-lost", "detail": str(e)}
        except Exception as e:  # malformed request: report, don't kill server
            resp = {"ok": False, "error": type(e).__name__, "detail": str(e)}
        self.wfile.write((json.dumps(resp) + "\n").encode("utf-8"))


class MembershipServer:
    """Threaded TCP front for one :class:`MembershipService`.

    One request per connection (connect, one JSON line each way, close) —
    stateless on the wire, so a worker that dies mid-request leaves no
    half-open session behind, and the client needs no reconnect logic.
    """

    def __init__(self, service: MembershipService,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.service = service  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"{host}:{port}"

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MembershipServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MembershipClient:
    """Worker-side stub.  Any transport failure — refused connection,
    timeout, torn socket, or the server answering ``coordinator-lost`` —
    surfaces as :class:`CoordinatorLost`: from a worker's point of view
    they are the same event, and all of them route to relaunch fallback."""

    def __init__(self, address: str, *, timeout: float = 5.0):
        host, _, port = address.rpartition(":")
        self.host, self.port = host, int(port)
        self.timeout = float(timeout)

    def _call(self, **req) -> dict:
        try:
            with socket.create_connection(
                    (self.host, self.port), timeout=self.timeout) as sock:
                sock.sendall((json.dumps(req) + "\n").encode("utf-8"))
                with sock.makefile("rb") as f:
                    line = f.readline()
        except OSError as e:
            raise CoordinatorLost(
                f"membership endpoint {self.host}:{self.port}: {e}") from e
        if not line:
            raise CoordinatorLost("membership coordinator closed connection")
        resp = json.loads(line.decode("utf-8"))
        if not resp.get("ok"):
            if resp.get("error") == "coordinator-lost":
                raise CoordinatorLost(resp.get("detail", "coordinator down"))
            raise RuntimeError(
                f"membership op {req['op']!r} failed: {resp}")
        return resp

    def register(self, rank: int) -> MemberView:
        return MemberView.from_wire(self._call(op="register", rank=rank))

    def seal(self) -> MemberView:
        return MemberView.from_wire(self._call(op="seal"))

    def heartbeat(self, rank: int, step: int | None = None) -> MemberView:
        return MemberView.from_wire(
            self._call(op="heartbeat", rank=rank, step=step))

    def view(self) -> MemberView:
        return MemberView.from_wire(self._call(op="view"))

    def detect_losses(self) -> tuple[int, ...]:
        return tuple(int(r) for r in self._call(op="detect")["lost"])

    def mark_lost(self, *ranks: int) -> MemberView:
        return MemberView.from_wire(
            self._call(op="mark_lost", ranks=list(ranks)))

    def ack(self, rank: int, epoch: int) -> MemberView:
        return MemberView.from_wire(
            self._call(op="ack", rank=rank, epoch=epoch))

    def barrier_complete(self, epoch: int) -> bool:
        return bool(self._call(op="barrier", epoch=epoch)["complete"])


def membership_env(address: str,
                   base: dict[str, str] | None = None) -> dict[str, str]:
    """Env block advertising the coordinator's membership endpoint —
    merged into :func:`repro_torch.launch.stencil.worker_env` output so
    grid workers find the service the way they find the store."""
    env = dict(base or {})
    env[MEMBERSHIP_VAR] = address
    return env


def serve_from_env(service: MembershipService,
                   env: dict[str, str] | None = None
                   ) -> MembershipServer | None:
    """Bind the advertised membership endpoint (the rank-0 side).

    :func:`repro_torch.launch.stencil.launch_grid` picks the port and
    stamps ``REPRO_TORCH_MEMBERSHIP`` into every rank's env; the rank-0 program calls
    this to actually host the service there.  ``None`` when the grid was
    launched without membership.
    """
    addr = (env if env is not None else os.environ).get(MEMBERSHIP_VAR)
    if not addr:
        return None
    host, _, port = addr.rpartition(":")
    return MembershipServer(service, host=host, port=int(port))


def client_from_env(env: dict[str, str] | None = None,
                    *, timeout: float = 5.0) -> MembershipClient | None:
    """A client for the advertised endpoint, or ``None`` when the grid
    was launched without a membership service."""
    addr = (env if env is not None else os.environ).get(MEMBERSHIP_VAR)
    return MembershipClient(addr, timeout=timeout) if addr else None
