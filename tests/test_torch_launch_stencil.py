"""The port's multi-process stencil grid (``repro_torch.launch.stencil``,
the ``multihost`` transport, ``chaos_scope``) against the JAX package.

* Launcher units, as JAX ``tests/core/test_mapping.py`` holds its own: the
  port-race classifier on a table of messages (torch's TCPStore bind
  failures retried; chaos, assertion and OOM deaths not), the retry with a
  fresh port, one run on success, the stderr tail on ``check=True``, the
  reap of workers blocked on a dead store, ``worker_env``'s stamping and
  scrubbing of the port's own ``REPRO_TORCH_*`` variables.
* One 2-process gloo grid on the CPU (``slow``: two worker processes), as
  JAX ``tests/distributed_progs/check_multihost.py``: a 1-axis mesh of 4
  ranks and a ``(2, 2)`` mesh whose first axis crosses the processes;
  every strategy x packers ``slice``/``cuda`` (their plain versions here) x
  coalesce on/off, ``partitioned`` at 3 parts, one ``auto`` cell; the
  workers write their rows and the parent holds them bitwise against JAX
  ``reference_exchange`` on the same numpy interior, ``bf16`` and
  ``scaled-int8`` within their ``wire_tolerance``; ``to_global_interior``
  and ``stored_from_stacked`` gather to process 0 the interior and JAX's
  stored layout.
* One chaos grid (``slow``): a ``chaos_scope`` probe raises in rank 1 while
  a plan is built mid-run; ``launch_grid(check=False)`` reports it, the
  other rank ends too, and no worker is left.
* In process: a raising probe leaves no plan in the ``PlanCache``; the
  ``multihost`` transport in one process is ``loopback``.
"""

import json
import os
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro.core.compat import make_mesh as j_make_mesh
from repro.stencil import Domain as JDomain
from repro.stencil.domain import reference_exchange as j_reference_exchange
from repro_torch.core import transport as t_tr
from repro_torch.core.mesh import make_mesh
from repro_torch.core.plan import PlanCache
from repro_torch.launch import stencil as t_launch
from repro_torch.stencil import Domain, StrategyConfig, make_driver, stacked_from_stored

torch.set_num_threads(1)

#: each grid launch's own bound (seconds)
GRID_TIMEOUT = 120.0


# ---------------------------------------------------------------------------
# launcher units
# ---------------------------------------------------------------------------

PORT_RACE_TABLE = [
    (["RuntimeError: Address already in use"], [1], True),
    (["bind: EADDRINUSE"], [1], True),
    (["", "failed to bind coordinator port"], [0, 1], True),
    # torch's TCPStore losing its port
    (["torch.distributed.DistNetworkError: The server socket has failed to listen on any "
      "local network address. port: 29500, useIpv6: false, code: -98, name: EADDRINUSE, "
      "message: address already in use"], [1], True),
    (["RuntimeError: The server socket has failed to bind to [::]:29500 (errno: 98 - "
      "Address already in use)."], [1], True),
    # a clean exit is never a race, whatever stderr says
    (["Address already in use"], [0], False),
    # real failures are never retried into silence
    (["AssertionError: chaos"], [1], False),
    (["SimulatedFailure: rank 1 lost at round"], [1], False),
    (["torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB"], [1], False),
    (["RuntimeError: [gloo/transport/tcp/pair.cc:537] Read error: Connection reset by peer"],
     [1], False),
]


@pytest.mark.parametrize("errs,rcs,race", PORT_RACE_TABLE)
def test_is_port_race_failure_signatures(errs, rcs, race):
    assert t_launch.is_port_race_failure(errs, rcs) is race


_MARKER_PROG = textwrap.dedent("""
    import sys
    with open(sys.argv[1], "a") as f:
        f.write("attempt\\n")
    print(sys.argv[2], file=sys.stderr)
    sys.exit(int(sys.argv[3]))
""")


def _launch_marker(tmp_path, *, stderr: str, exit_code: int, attempts: int):
    prog = tmp_path / "prog.py"
    prog.write_text(_MARKER_PROG)
    marker = tmp_path / "marker"
    marker.write_text("")
    result = t_launch.launch_grid(
        [sys.executable, str(prog), str(marker), stderr, str(exit_code)],
        processes=1, timeout=GRID_TIMEOUT, check=False, attempts=attempts,
    )
    return result, marker.read_text().count("attempt")


def test_launch_grid_retries_port_race_with_fresh_port(tmp_path):
    result, runs = _launch_marker(tmp_path, stderr="errno: 98 - Address already in use",
                                  exit_code=1, attempts=3)
    assert not result.ok and runs == 3


def test_launch_grid_does_not_retry_real_failures(tmp_path):
    result, runs = _launch_marker(tmp_path, stderr="AssertionError: genuinely broken",
                                  exit_code=1, attempts=3)
    assert not result.ok and result.failed_ranks == (0,) and runs == 1


def test_launch_grid_success_runs_once(tmp_path):
    result, runs = _launch_marker(tmp_path, stderr="noise", exit_code=0, attempts=3)
    assert result.ok and result.failed_ranks == () and runs == 1


def test_launch_grid_check_raises_with_stderr_tail(tmp_path):
    prog = tmp_path / "prog.py"
    prog.write_text(_MARKER_PROG)
    with pytest.raises(RuntimeError, match="genuinely broken"):
        t_launch.launch_grid(
            [sys.executable, str(prog), str(tmp_path / "marker"),
             "AssertionError: genuinely broken", "1"],
            processes=1, timeout=GRID_TIMEOUT, attempts=2,
        )


_ZOMBIE_PROG = textwrap.dedent("""
    import os, sys, time
    if os.environ["REPRO_TORCH_PROCESS_ID"] == "0":
        print("store died before binding", file=sys.stderr)
        sys.exit(1)
    time.sleep(600)  # a worker blocked connecting to the dead store
""")


def test_launch_grid_reaps_workers_blocked_on_dead_coordinator(tmp_path):
    prog = tmp_path / "prog.py"
    prog.write_text(_ZOMBIE_PROG)
    t0 = time.monotonic()
    result = t_launch.launch_grid([sys.executable, str(prog)], processes=2,
                                  timeout=GRID_TIMEOUT, check=False, attempts=1, reap_grace=1.0)
    assert time.monotonic() - t0 < 60.0, "the reap did not bound the hang"
    # both ranks are reported: the dead store and the reaped worker
    assert result.failed_ranks == (0, 1), result.returncodes
    assert result.returncodes[0] == 1 and result.returncodes[1] < 0
    assert "store died" in result.errs[0]


def test_worker_env_stamps_and_scrubs_the_ports_own_variables():
    env = t_launch.worker_env(coordinator="127.0.0.1:9999", num_processes=2, process_id=1,
                              base={"REPRO_COORDINATOR": "10.0.0.1:1"}, connect_timeout=45.0)
    assert env[t_launch.COORDINATOR_VAR] == "127.0.0.1:9999"
    assert env[t_launch.NUM_PROCESSES_VAR] == "2" and env[t_launch.PROCESS_ID_VAR] == "1"
    assert env[t_launch.CONNECT_TIMEOUT_VAR] == "45.0"
    assert env["GLOO_SOCKET_IFNAME"] == "lo"
    assert all(v.startswith("REPRO_TORCH_") for v in (
        t_launch.COORDINATOR_VAR, t_launch.NUM_PROCESSES_VAR, t_launch.PROCESS_ID_VAR,
        t_launch.CONNECT_TIMEOUT_VAR))
    # the JAX package's grid variable is not the port's: a JAX grid's
    # coordinates never make a port worker join it
    assert env["REPRO_COORDINATOR"] == "10.0.0.1:1"
    src = os.path.abspath(os.path.join(os.path.dirname(t_launch.__file__), "..", ".."))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == src

    stale = dict(env)
    clean = t_launch.worker_env(base=stale)
    for var in (t_launch.COORDINATOR_VAR, t_launch.NUM_PROCESSES_VAR, t_launch.PROCESS_ID_VAR,
                t_launch.CONNECT_TIMEOUT_VAR):
        assert var not in clean
    # outside a grid a worker joins nothing
    assert t_launch.process_grid() == (1, 0)


# ---------------------------------------------------------------------------
# in process: the chaos seam and multihost in one process
# ---------------------------------------------------------------------------


class SimulatedFailure(RuntimeError):
    pass


def test_raising_probe_leaves_no_plan_in_the_cache():
    mesh = make_mesh((4,), ("px",), device="cpu")
    dom = Domain(mesh, (16, 8), ("px", None))
    cache = PlanCache()
    drv = make_driver(StrategyConfig(name="partitioned", n_parts=2, plan_cache=cache),
                      mesh, dom.halo_spec, ndim=2)
    x = dom.random(0)
    points = []

    def probe(point):
        points.append(point)
        if point == "round":
            raise SimulatedFailure("lost mid-assembly")

    with t_tr.chaos_scope(probe):
        with pytest.raises(SimulatedFailure):
            drv.init(x)
    assert points == ["group", "round"]
    assert len(cache) == 0 and cache.stats.inits == 0 and drv.plan is None
    assert t_tr._CHAOS_PROBE is None  # the scope restored the seam
    # outside the scope the same driver builds its plan: one group (one
    # decomposed axis), two coalesced rounds
    seen = []
    with t_tr.chaos_scope(seen.append):
        drv.init(x)
    assert seen == ["group", "round", "round"]
    assert len(cache) == 1 and cache.stats.inits == 1
    drv.free()
    cache.free_all()


def test_multihost_in_one_process_is_loopback():
    mesh = make_mesh((4, 2), ("px", "py"), device="cpu")
    mh, lb = t_tr.get_transport("multihost"), t_tr.get_transport("loopback")
    assert t_tr.available_transports() == ("loopback", "multihost")
    assert mh.capturable(mesh) and lb.capturable(mesh)
    grid = make_mesh((4, 2), ("px", "py"), device="cpu", processes=2)
    assert not mh.capturable(grid)
    with pytest.raises(ValueError, match="cannot cross processes"):
        lb.route_table(("px", ((0, 1), (1, 2), (2, 3), (3, 0))), grid)
    with pytest.raises(RuntimeError, match="torch.distributed grid"):
        mh.route_table(("px", ((0, 1), (1, 2), (2, 3), (3, 0))), grid,
                       torch.empty(4, 3))
    dom = Domain(mesh, (16, 8), ("px", "py"))
    x0 = dom.random(3)
    got = {}
    for name in ("loopback", "multihost"):
        drv = make_driver(StrategyConfig(name="fused", transport=name), mesh, dom.halo_spec,
                          ndim=2)
        got[name] = drv.wait(drv.step(x0.clone()))
        drv.free()
    assert torch.equal(got["loopback"], got["multihost"])


# ---------------------------------------------------------------------------
# the 2-process grid against JAX reference_exchange
# ---------------------------------------------------------------------------

#: mesh key -> (mesh shape, axis names, global interior, domain axes)
MESHES = {
    "row": ((4,), ("px",), (16, 8), ("px", None)),
    "grid": ((2, 2), ("px", "py"), (8, 6), ("px", "py")),
}
STRATEGIES = ("standard", "persistent", "partitioned", "fused", "overlap")
SEED = 7

_GRID_PROG = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.stencil import maybe_initialize_from_env
    rank = maybe_initialize_from_env()
    from repro_torch.core.mesh import make_mesh
    from repro_torch.stencil import Domain, StrategyConfig, make_driver, stored_from_stacked
    meshes, strategies, seed, out = json.loads(sys.argv[1])
    rows, picked = {}, None
    for key, (shape, names, size, axes) in meshes.items():
        mesh = make_mesh(shape, names, device="cpu", processes=2, process_index=rank)
        dom = Domain(mesh, tuple(size), tuple(axes))
        interior = np.random.default_rng(seed).normal(size=size).astype(np.float32)
        cells = [(s, p, c) for s in strategies for p in ("slice", "cuda") for c in (True, False)]
        if key == "row":
            cells += [(s, p, True) for s in ("persistent", "partitioned")
                      for p in ("bf16", "scaled-int8")]
            cells += [("auto", "slice", True)]
        for s, p, c in cells:
            cfg = StrategyConfig(name=s, packer=p, coalesce=c, transport="multihost",
                                 n_parts=3 if s == "partitioned" else 1)
            drv = make_driver(cfg, mesh, dom.halo_spec, ndim=len(size))
            got = drv.wait(drv.step(dom.from_global_interior(interior)))
            if s == "auto":
                picked = [drv.strategy, drv.config.packer, drv.config.coalesce, drv.n_parts,
                          drv.selected_by]
            drv.free()
            rows[f"{key}/{s}/{p}/{int(c)}"] = got.numpy()
            if (s, p, c) == ("persistent", "slice", True):
                exchanged = got
        rows[f"{key}/coords"] = np.array(mesh.local_coords)
        # collectives: process 0 gets the whole arrays, the other None
        interior_back = dom.to_global_interior(exchanged)
        stored = stored_from_stacked(dom, exchanged)
        assert (interior_back is None) == (stored is None) == (rank != 0)
        if rank == 0:
            np.save(f"{out}/{key}_interior.npy", interior_back)
            np.save(f"{out}/{key}_stored.npy", stored)
    np.savez(f"{out}/rank{rank}.npz", **rows)
    with open(f"{out}/auto{rank}.json", "w") as f:
        json.dump(picked, f)
""")


def _grid_env(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               REPRO_TORCH_AUTOTUNE_CACHE=str(tmp_path / "autotune.json"))
    env.pop("REPRO_TORCH_AUTOTUNE_TRACE", None)
    return env


@pytest.mark.slow
def test_two_process_grid_equals_jax_reference_exchange(tmp_path):
    prog = tmp_path / "grid.py"
    prog.write_text(_GRID_PROG)
    t_launch.launch_grid(
        [sys.executable, str(prog), json.dumps([MESHES, STRATEGIES, SEED, str(tmp_path)])],
        processes=2, timeout=GRID_TIMEOUT, env=_grid_env(tmp_path),
    )
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    checked = 0
    for key, (shape, names, size, axes) in MESHES.items():
        interior = np.random.default_rng(SEED).normal(size=size).astype(np.float32)
        jdom = JDomain(j_make_mesh(shape, names), global_interior=size, mesh_axes=axes)
        stored = j_reference_exchange(jdom, interior)
        # gathered to process 0: the interior it started from, and JAX's
        # stored layout of the exchanged block
        np.testing.assert_array_equal(np.load(tmp_path / f"{key}_interior.npy"), interior)
        np.testing.assert_array_equal(np.load(tmp_path / f"{key}_stored.npy"), stored)
        # the whole-mesh stacked layout of JAX's reference, one row a coordinate
        one = Domain(make_mesh(shape, names, device="cpu"), size, axes)
        want = stacked_from_stored(one, stored).reshape(
            int(np.prod(shape)), *one.local_ghosted).numpy()
        coords = [tuple(r[f"{key}/coords"]) for r in ranks]
        # the first mesh axis crosses the processes: each holds half of it
        assert sorted(coords[0] + coords[1]) == list(range(int(np.prod(shape))))
        assert coords[0] == tuple(range(len(coords[0])))
        cells = sorted(k for k in ranks[0].files
                       if k.startswith(key + "/") and not k.endswith("/coords"))
        for cell in cells:
            packer = cell.split("/")[2]
            rtol, atol = t_tr.get_packer(packer).wire_tolerance("float32")
            for r, rank in enumerate(ranks):
                got, ref = rank[cell], want[list(coords[r])]
                if rtol == atol == 0.0:
                    np.testing.assert_array_equal(got, ref, err_msg=f"{cell} rank {r}")
                else:
                    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                               err_msg=f"{cell} rank {r}")
            checked += 1
    assert checked == 2 * 5 * 2 * 2 + 4 + 1
    # the auto cell: both processes took rank 0's probe times and so the
    # same winner, calibrated once and cached in the one file they share
    picked = [json.loads((tmp_path / f"auto{r}.json").read_text()) for r in range(2)]
    assert picked[0] == picked[1] and picked[0][4] == "calibration", picked
    assert picked[0][1] == "slice" and picked[0][2] is True
    assert len(json.loads((tmp_path / "autotune.json").read_text())) == 1


_CHAOS_PROG = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.stencil import maybe_initialize_from_env
    rank = maybe_initialize_from_env()
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.transport import chaos_scope
    from repro_torch.stencil import Domain, StrategyConfig, make_driver

    class SimulatedFailure(RuntimeError):
        pass

    def probe(point):
        if rank == 1 and point == "round":
            raise SimulatedFailure(f"rank {rank} lost at {point}")

    mesh = make_mesh((4,), ("px",), device="cpu", processes=2, process_index=rank)
    dom = Domain(mesh, (16, 8), ("px", None))
    x = dom.random(0)
    drv = make_driver(StrategyConfig(name="persistent", transport="multihost"), mesh,
                      dom.halo_spec, ndim=2)
    for _ in range(3):
        x = drv.step(x)
    drv.wait(x)
    print(f"rank {rank}: 3 cycles", flush=True)
    with chaos_scope(probe):  # mid-run: the next plan's build is attacked
        part = make_driver(StrategyConfig(name="partitioned", n_parts=2,
                                          transport="multihost"), mesh, dom.halo_spec, ndim=2)
        x = part.wait(part.step(x))
    print(f"rank {rank}: survived", flush=True)
""")


@pytest.mark.slow
def test_chaos_probe_kills_a_rank_and_the_grid_ends(tmp_path):
    prog = tmp_path / "chaos.py"
    prog.write_text(_CHAOS_PROG)
    t0 = time.monotonic()
    result = t_launch.launch_grid([sys.executable, str(prog)], processes=2,
                                  timeout=GRID_TIMEOUT, env=_grid_env(tmp_path), check=False,
                                  attempts=1, reap_grace=5.0)
    assert time.monotonic() - t0 < GRID_TIMEOUT
    assert all(rc is not None for rc in result.returncodes)  # no worker left
    assert "SimulatedFailure: rank 1 lost at round" in result.errs[1]
    assert all("3 cycles" in out for out in result.outs)
    assert not any("survived" in out for out in result.outs)
    # rank 0 was left waiting on its dead peer: gloo reports the lost
    # connection and it exits non-zero itself, or the launcher reaps it
    assert result.failed_ranks == (0, 1), result.returncodes
    assert result.returncodes[0] < 0 or "Connection" in result.errs[0], result.errs[0][-2000:]
