"""The port's ``launch/membership.py`` against the JAX package's.

* The same operation sequences on JAX's ``MembershipService`` and the
  port's, both under one fake clock, give equal ``MemberView.to_wire()``
  results (and equal loss detections, barriers and errors) at every step.
* The JAX package's unit cases on the port: epochs, heartbeat windows, the
  barrier, a dead coordinator, a successor's epoch, a TCP round trip over
  a real localhost socket, a refused connect.
* The env plumbing under the port's own ``REPRO_TORCH_MEMBERSHIP`` (never
  the JAX package's ``REPRO_MEMBERSHIP``), ``worker_env(membership=)``, and
  ``launch_grid(membership=True)`` binding the service in a worker through
  ``serve_from_env``.
"""

import os
import sys
import textwrap

import pytest
import torch

from repro.launch import membership as j_mb
from repro_torch.launch import membership as t_mb
from repro_torch.launch import stencil as t_launch
from repro_torch.train.fault_tolerance import EpochBump

torch.set_num_threads(1)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _sealed(mb, n=2, timeout=1.0):
    clock = FakeClock()
    svc = mb.MembershipService(heartbeat_timeout=timeout, clock=clock)
    for r in range(n):
        svc.register(r)
    svc.seal()
    return svc, clock


# ---------------------------------------------------------------------------
# the same sequences on both services
# ---------------------------------------------------------------------------

#: (op, args); "tick" advances the shared clock
SEQUENCES = {
    "form-join-loss": [
        ("register", (0,)), ("register", (1,)), ("register", (2,)), ("seal", ()),
        ("heartbeat", (0, 1)), ("register", (7,)), ("tick", (0.6,)), ("heartbeat", (0, 2)),
        ("heartbeat", (7, 2)), ("tick", (0.6,)), ("detect", ()), ("mark_lost", (1, 2)),
        ("mark_lost", (1,)), ("ack", (0, 2)), ("barrier", (2,)), ("ack", (7, 2)),
        ("barrier", (2,)), ("view", ()),
    ],
    "stale-acks-and-rejoin": [
        ("register", (0,)), ("register", (1,)), ("seal", ()), ("mark_lost", (1,)),
        ("ack", (0, 0)), ("barrier", (1,)), ("ack", (0, 1)), ("barrier", (1,)),
        ("register", (1,)), ("barrier", (2,)), ("heartbeat", (1, 9)), ("register", (1,)),
        ("tick", (5.0,)), ("detect", ()), ("heartbeat", (5,)), ("view", ()),
    ],
    "coordinator-dies": [
        ("register", (0,)), ("seal", ()), ("heartbeat", (0, 1)), ("fail", ()),
        ("heartbeat", (0, 2)), ("register", (3,)), ("detect", ()), ("ack", (0, 0)),
    ],
}


def _apply(svc, clock, op, args):
    """One op's observable result: a wire dict, a value, or the error."""
    try:
        if op == "tick":
            clock.t += args[0]
            return None
        if op == "view":
            return svc.view.to_wire()
        if op == "detect":
            return list(svc.detect_losses())
        if op == "barrier":
            return svc.barrier_complete(*args)
        if op == "fail":
            return svc.fail()
        return getattr(svc, op)(*args).to_wire()
    except Exception as e:  # both must raise the same way
        return ("raised", type(e).__name__)


@pytest.mark.parametrize("name", list(SEQUENCES))
@pytest.mark.parametrize("start_epoch", [0, 4])
def test_same_operations_give_the_same_views_as_jax(name, start_epoch):
    clocks = {"jax": FakeClock(), "torch": FakeClock()}
    svcs = {"jax": j_mb.MembershipService(heartbeat_timeout=1.0, clock=clocks["jax"],
                                          start_epoch=start_epoch),
            "torch": t_mb.MembershipService(heartbeat_timeout=1.0, clock=clocks["torch"],
                                            start_epoch=start_epoch)}
    for op, args in SEQUENCES[name]:
        got = {k: _apply(svcs[k], clocks[k], op, args) for k in svcs}
        assert got["torch"] == got["jax"], (op, args, got)
    assert svcs["torch"].alive == svcs["jax"].alive


def test_member_view_wire_round_trip_matches_jax():
    view = t_mb.MemberView(epoch=3, members=(0, 2, 5), cause="join")
    jview = j_mb.MemberView(epoch=3, members=(0, 2, 5), cause="join")
    assert view.to_wire() == jview.to_wire()
    assert t_mb.MemberView.from_wire(jview.to_wire()) == view


# ---------------------------------------------------------------------------
# the service alone
# ---------------------------------------------------------------------------


def test_formation_then_seal_is_epoch_zero():
    svc, _ = _sealed(t_mb, 3)
    assert svc.view == t_mb.MemberView(epoch=0, members=(0, 1, 2), cause="form")


def test_register_after_seal_is_a_join_bump():
    svc, _ = _sealed(t_mb, 2)
    view = svc.register(7)
    assert view.epoch == 1 and view.cause == "join" and view.members == (0, 1, 7)
    assert svc.register(7).epoch == 1


def test_missed_heartbeats_detected_and_loss_bumps_epoch():
    svc, clock = _sealed(t_mb, 2, timeout=1.0)
    clock.t = 0.9
    svc.heartbeat(0)
    clock.t = 1.5
    assert svc.detect_losses() == (1,)
    assert svc.mark_lost(1) == t_mb.MemberView(epoch=1, members=(0,), cause="loss")
    assert svc.mark_lost(1).epoch == 1


def test_barrier_requires_every_current_member():
    svc, _ = _sealed(t_mb, 3)
    svc.mark_lost(2)
    assert not svc.barrier_complete(1)
    svc.ack(0, epoch=1)
    assert not svc.barrier_complete(1)
    svc.ack(1, epoch=1)
    assert svc.barrier_complete(1)
    svc.register(9)
    assert not svc.barrier_complete(1) and not svc.barrier_complete(2)


def test_dead_coordinator_raises_everywhere():
    svc, _ = _sealed(t_mb, 2)
    svc.fail()
    assert not svc.alive
    for call in (lambda: svc.heartbeat(0), lambda: svc.register(3),
                 lambda: svc.detect_losses(), lambda: svc.mark_lost(1),
                 lambda: svc.ack(0, 0), lambda: svc.seal(), lambda: svc.barrier_complete(0)):
        with pytest.raises(t_mb.CoordinatorLost):
            call()


def test_successor_coordinator_seeds_a_later_epoch():
    svc = t_mb.MembershipService(start_epoch=4)
    svc.register(0)
    assert svc.seal().epoch == 4
    assert svc.register(1).epoch == 5


def test_the_service_uses_the_ports_epoch_type():
    svc, _ = _sealed(t_mb, 1)
    assert isinstance(svc._epoch, EpochBump)


# ---------------------------------------------------------------------------
# the TCP wire
# ---------------------------------------------------------------------------


def test_tcp_round_trip_mirrors_the_service():
    svc, clock = _sealed(t_mb, 2, timeout=1.0)
    with t_mb.MembershipServer(svc) as srv:
        cli = t_mb.MembershipClient(srv.address, timeout=5.0)
        assert cli.view() == svc.view
        assert cli.heartbeat(0, step=3).epoch == 0
        view = cli.register(9)
        assert view.epoch == 1 and view.cause == "join"
        clock.t = 2.0
        cli.heartbeat(0)
        assert cli.detect_losses() == (1, 9)
        view = cli.mark_lost(1, 9)
        assert view.members == (0,) and view.epoch == 2
        cli.ack(0, 2)
        assert cli.barrier_complete(2)
        # a malformed request is answered, not fatal to the server
        with pytest.raises(RuntimeError, match="failed"):
            cli._call(op="no-such-op")
        assert cli.view().epoch == 2


def test_a_jax_client_reads_the_ports_server():
    """One wire protocol: the JSON lines are the JAX package's."""
    svc, _ = _sealed(t_mb, 2)
    with t_mb.MembershipServer(svc) as srv:
        assert j_mb.MembershipClient(srv.address).view().to_wire() == svc.view.to_wire()


def test_tcp_surfaces_coordinator_death_and_refused_connect():
    svc, _ = _sealed(t_mb, 2)
    srv = t_mb.MembershipServer(svc)
    cli = t_mb.MembershipClient(srv.address, timeout=5.0)
    svc.fail()
    with pytest.raises(t_mb.CoordinatorLost):
        cli.heartbeat(0)
    srv.close()
    with pytest.raises(t_mb.CoordinatorLost):
        t_mb.MembershipClient(srv.address, timeout=0.5).view()


# ---------------------------------------------------------------------------
# env plumbing and the grid launcher
# ---------------------------------------------------------------------------


def test_env_plumbing_round_trip_under_the_ports_variable():
    assert t_mb.MEMBERSHIP_VAR == "REPRO_TORCH_MEMBERSHIP" != j_mb.MEMBERSHIP_VAR
    env = t_mb.membership_env("127.0.0.1:7777", base={"OTHER": "x"})
    assert env[t_mb.MEMBERSHIP_VAR] == "127.0.0.1:7777" and env["OTHER"] == "x"
    cli = t_mb.client_from_env(env)
    assert (cli.host, cli.port) == ("127.0.0.1", 7777)
    assert t_mb.client_from_env({}) is None
    # a JAX grid's endpoint is never the port's
    assert t_mb.client_from_env(j_mb.membership_env("127.0.0.1:7777")) is None
    assert j_mb.client_from_env(env) is None
    assert t_mb.serve_from_env(t_mb.MembershipService(), {}) is None
    srv = t_mb.serve_from_env(t_mb.MembershipService(), t_mb.membership_env("127.0.0.1:0"))
    try:
        assert t_mb.MembershipClient(srv.address).view().epoch == 0
    finally:
        srv.close()


def test_worker_env_stamps_and_scrubs_the_membership_endpoint():
    env = t_launch.worker_env(coordinator="127.0.0.1:9", num_processes=2, process_id=0,
                              base={"REPRO_MEMBERSHIP": "10.0.0.1:1"},
                              membership="127.0.0.1:4242")
    assert env[t_mb.MEMBERSHIP_VAR] == "127.0.0.1:4242"
    assert env["REPRO_MEMBERSHIP"] == "10.0.0.1:1"  # the JAX package's, untouched
    assert t_mb.MEMBERSHIP_VAR not in t_launch.worker_env(base=env)


_SERVE_PROG = textwrap.dedent("""
    import os, sys
    from repro_torch.launch.membership import (
        MEMBERSHIP_VAR, MembershipService, client_from_env, serve_from_env)
    srv = serve_from_env(MembershipService())
    try:
        cli = client_from_env()
        cli.register(0)
        view = cli.seal()
        print(os.environ[MEMBERSHIP_VAR], srv.address, view.epoch, list(view.members))
    finally:
        srv.close()
""")


def test_launch_grid_advertises_a_membership_port(tmp_path):
    prog = tmp_path / "serve.py"
    prog.write_text(_SERVE_PROG)
    out = t_launch.launch_grid([sys.executable, str(prog)], processes=1, timeout=60.0,
                               membership=True)
    advertised, bound, epoch, members = out.split(maxsplit=3)
    assert advertised == bound and advertised.startswith("127.0.0.1:")
    assert (epoch, members.strip()) == ("0", "[0]")
    # without membership= the variable is scrubbed from the workers' env
    env = dict(os.environ, REPRO_TORCH_MEMBERSHIP="127.0.0.1:1")
    prog.write_text("import os; print(os.environ.get('REPRO_TORCH_MEMBERSHIP'))")
    assert t_launch.launch_grid([sys.executable, str(prog)], processes=1, timeout=60.0,
                                env=env).strip() == "None"
