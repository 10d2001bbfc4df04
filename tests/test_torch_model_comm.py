"""The port's copy of the paper's analytic model (``repro_torch/core/
model_comm.py``) and its calibrated constants (``repro_torch/configs/
comb_paper.py``) against the JAX package's originals.

Both are pure Python with the arithmetic in the same order, so every
comparison here is exact (``==``, no tolerance): ``simulate`` for all
three strategies at every point of the four figure grids, walked as
``benchmarks/figures.py`` walks them (``threads``, ``ranks_per_node`` and
``n_parts`` from the grid), the machine constants, the workloads'
messages and ``_near_cubic_grid``.  The JAX file's paper-claim tests (C1,
C3-C6) are run again on the port's copy.
"""

import dataclasses

import pytest

from repro.configs import comb_paper as j_cp
from repro.core import model_comm as j_mc
from repro_torch.configs import comb_paper as t_cp
from repro_torch.core import model_comm as t_mc

STRATEGIES = ("standard", "persistent", "partitioned")


def _grid_points():
    """(figure, workload maker, nprocs, ranks_per_node, threads, n_parts)
    for every point of the four figure grids; the workload maker takes a
    comb_paper module."""
    pts = []
    f2 = j_cp.FIG2_WEAK
    for n in f2["procs"]:
        pts.append(("fig2", lambda cp: cp.fig2_workload(), n, f2["ranks_per_node"],
                    f2["threads"], None))
    f3 = j_cp.FIG3_STRONG
    for n in f3["procs"]:
        pts.append(("fig3", lambda cp, n=n: cp.fig3_workload(n), n, f3["ranks_per_node"],
                    f3["threads"], None))
    f4 = j_cp.FIG4_MSG_SIZE
    for d in f4["doubles"]:
        pts.append(("fig4", lambda cp, d=d: cp.fig4_workload(d), f4["procs"],
                    f4["ranks_per_node"], f4["threads"], None))
    f5 = j_cp.FIG5_RANKS_PER_NODE
    for rpn in f5["ranks_per_node"]:
        n = f5["nodes"] * rpn
        threads = f5["threads_per_node"] // rpn
        pts.append(("fig5", lambda cp, n=n: cp.fig5_workload(n), n, rpn, threads, None))
        # the partition count set apart from the thread count, as Fig. 5's
        # partitions-per-thread discussion varies it
        pts.append(("fig5", lambda cp, n=n: cp.fig5_workload(n), n, rpn, threads, 2 * threads))
    return pts


POINTS = _grid_points()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("point", POINTS,
                         ids=[f"{p[0]}-n{p[2]}-rpn{p[3]}-t{p[4]}-p{p[5]}" for p in POINTS])
def test_simulate_equals_jax_on_the_figure_grids(point, strategy):
    _, workload, n, rpn, threads, parts = point
    kw = dict(nprocs=n, ranks_per_node=rpn, threads=threads, n_parts=parts)
    want = j_mc.simulate(strategy, j_cp.QUARTZ, workload(j_cp), **kw)
    got = t_mc.simulate(strategy, t_cp.QUARTZ, workload(t_cp), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total == want.total


@pytest.mark.parametrize("iters", [1, 7, 1000])
def test_simulate_equals_jax_off_the_grids(iters):
    """Default machine, explicit workloads, amortization and speedups."""
    for wl_shape in ((64, 64, 64), (5, 300, 17), (1, 1, 1)):
        jw, tw = j_mc.StencilWorkload(wl_shape), t_mc.StencilWorkload(wl_shape)
        for n, rpn in ((8, 32), (512, 16), (4096, 1)):
            jb = j_mc.simulate("standard", j_mc.MachineModel(), jw, nprocs=n,
                               ranks_per_node=rpn, iters=iters)
            tb = t_mc.simulate("standard", t_mc.MachineModel(), tw, nprocs=n,
                               ranks_per_node=rpn, iters=iters)
            for s in STRATEGIES[1:]:
                jo = j_mc.simulate(s, j_mc.MachineModel(), jw, nprocs=n, ranks_per_node=rpn,
                                   threads=40, iters=iters)
                to = t_mc.simulate(s, t_mc.MachineModel(), tw, nprocs=n, ranks_per_node=rpn,
                                   threads=40, iters=iters)
                assert dataclasses.asdict(to) == dataclasses.asdict(jo)
                assert t_mc.speedup(tb, to) == j_mc.speedup(jb, jo)


def test_constants_and_grids_equal_jax():
    assert dataclasses.asdict(t_cp.QUARTZ) == dataclasses.asdict(j_cp.QUARTZ)
    assert dataclasses.asdict(t_mc.MachineModel()) == dataclasses.asdict(j_mc.MachineModel())
    for name in ("FIG2_WEAK", "FIG3_STRONG", "FIG4_MSG_SIZE", "FIG5_RANKS_PER_NODE"):
        assert getattr(t_cp, name) == getattr(j_cp, name), name
    m = t_cp.QUARTZ
    for n, rpn, threads in ((64, 32, 2), (4096, 32, 2), (64, 1, 64), (2048, 16, 70)):
        jm = j_cp.QUARTZ
        assert m.beta_eff(n, rpn) == jm.beta_eff(n, rpn)
        assert m.burst_eff(n) == jm.burst_eff(n)
        assert m.pack_threads_eff(threads, rpn) == jm.pack_threads_eff(threads, rpn)


def test_workload_messages_equal_jax():
    for _, workload, n, *_ in POINTS:
        assert workload(t_cp).messages() == workload(j_cp).messages()
        assert workload(t_cp).local_cells == workload(j_cp).local_cells
    for face in (1, 3, 768, 524_288, 10**7):
        assert (t_mc.StencilWorkload.from_face_doubles(face).messages()
                == j_mc.StencilWorkload.from_face_doubles(face).messages())
    assert (t_mc.StencilWorkload((7, 5, 3), vars_per_cell=2, halo=2, elem_bytes=4).messages()
            == j_mc.StencilWorkload((7, 5, 3), vars_per_cell=2, halo=2, elem_bytes=4).messages())


def test_near_cubic_grid_equals_jax_up_to_4096():
    for n in range(1, 4097):
        assert t_mc._near_cubic_grid(n) == j_mc._near_cubic_grid(n), n


def test_pack_finish_times_equal_jax():
    items = [float(b) / 3 for b in (24, 1536, 98304, 7, 12288, 3)]
    for threads in (0, 1, 2, 5, 64):
        assert (t_mc._pack_finish_times(items, threads, 2.2e9)
                == j_mc._pack_finish_times(items, threads, 2.2e9))


def test_comb_paper_is_not_a_model_config():
    """The Quartz constants ride beside the model configs, registered as
    none of them: the registry lists models alone."""
    import repro_torch.configs as configs
    from repro_torch.configs import base

    names = set(base._REGISTRY)
    assert configs.comb_paper is t_cp
    assert names and not any("comb" in n or "quartz" in n.lower() for n in names)
    assert all(isinstance(base.get_config(n), base.ModelConfig) for n in names)
    from repro_torch.models.api import _FAMILY_MODULES

    assert all(base.get_config(n).family in _FAMILY_MODULES for n in names)


# -- the JAX file's paper claims, on the port's copy ----------------------------


def _trio(wl, n, rpn=32, threads=2, parts=None):
    b = t_mc.simulate("standard", t_cp.QUARTZ, wl, nprocs=n, ranks_per_node=rpn,
                      threads=threads)
    p = t_mc.simulate("persistent", t_cp.QUARTZ, wl, nprocs=n, ranks_per_node=rpn,
                      threads=threads)
    q = t_mc.simulate("partitioned", t_cp.QUARTZ, wl, nprocs=n, ranks_per_node=rpn,
                      threads=threads, n_parts=parts)
    return b, p, q


def test_c1_persistent_never_slower():
    for n in (64, 256, 1024, 4096):
        b, p, _ = _trio(t_mc.StencilWorkload.from_face_doubles(524_288), n)
        assert t_mc.speedup(b, p) > 0, n


def test_c3_partitioned_loses_small_messages():
    b, _, q = _trio(t_mc.StencilWorkload.from_face_doubles(768), 4096)
    assert t_mc.speedup(b, q) < -20


def test_c4_crossover_with_message_size():
    b_small, _, q_small = _trio(t_mc.StencilWorkload.from_face_doubles(768), 4096)
    b_large, _, q_large = _trio(t_mc.StencilWorkload.from_face_doubles(196_608), 4096)
    assert t_mc.speedup(b_small, q_small) < 0 < t_mc.speedup(b_large, q_large)


def test_c5_partition_count_cliff():
    wl = t_mc.StencilWorkload.from_global_mesh((2048, 4096, 4096), 64)
    b1, _, q1 = _trio(wl, 64, rpn=1, threads=64)
    wl32 = t_mc.StencilWorkload.from_global_mesh((2048, 4096, 4096), 2048)
    b32, _, q32 = _trio(wl32, 2048, rpn=32, threads=2)
    assert t_mc.speedup(b1, q1) < 0 < t_mc.speedup(b32, q32)


def test_c6_weak_scaling_rises():
    wl = t_mc.StencilWorkload.from_face_doubles(524_288)
    b64, _, _ = _trio(wl, 64)
    b4096, _, _ = _trio(wl, 4096)
    assert b4096.total > b64.total
