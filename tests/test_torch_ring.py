"""The port's ring primitives (``repro_torch/core/ring.py``): ring attention
and recurrent-state passing on the stacked ranks of a ``VirtualMesh``.

* The ``messages`` path (every hop a ``PreparedExchange`` delivery of the
  stacked KV buffer) is bitwise-equal to the bare-permute path for the
  exact packers, coalesced or not, with ``n_parts`` 1 and 3 at ``skv = 4``
  (the clipped remainder tail).
* Both hold to JAX's single-device ``attention_ref`` on the whole sequence,
  causal and not, and three cells hold to JAX ``ring_attention`` itself
  under ``shard_map`` on a ring of 4 (one jitted program for all three).
* The KV hop is a persistent plan in the registry, built once per
  structure, as ``Transport.permute``'s routes are.
* Collectives a call: ring - 1 moves coalesced, twice that uncoalesced or
  bare, ``n_parts`` times that partitioned and coalesced, the count JAX's
  ``tests/core/test_ring_messages.py`` reads from its compiled HLO.
* ``state_passing`` ``ring`` and ``tree`` against JAX's under
  ``shard_map``.

Tolerances, stated: f32; the ring against a one-device softmax (JAX's
oracle, or JAX's own ring) within ``rtol=atol=2e-5`` (the online softmax
rescales and sums the blocks in another order), as
``tests/core/test_ring_messages.py``; ``state_passing`` within
``rtol=atol=1e-5`` (products and sums of 4 terms).  The ``cuda`` test runs
on the card: the ``cuda`` packer bitwise against ``slice``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compat as j_compat
from repro.core import ring as j_ring
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.core import ring as t_ring
from repro_torch.core.mesh import make_mesh
from repro_torch.core.transport import LoopbackTransport, scheduled_collective_count

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)


def _jax_devices(n: int) -> list:
    """n JAX devices for a ``shard_map`` cell (the conftest's virtual CPU
    devices); skips where there are fewer, as on a card's machine."""
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices (conftest)")
    return jax.devices()[:n]


B, H, HKV, D = 2, 4, 2, 8
RING_TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(ring, sq=4, skv=4, seed=0):
    """Stacked numpy (ring, B, S, ...) q, k, v from a seed."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(ring, B, sq, H, D)).astype(np.float32)
    k = rng.normal(size=(ring, B, skv, HKV, D)).astype(np.float32)
    v = rng.normal(size=(ring, B, skv, HKV, D)).astype(np.float32)
    return q, k, v


def _global(x):
    """Stacked (ring, B, s, ...) -> the whole sequence (B, ring * s, ...)."""
    return np.moveaxis(x, 0, 1).reshape(x.shape[1], -1, *x.shape[3:])


def _ring(ring, q, k, v, device="cpu", **kw):
    mesh = make_mesh((ring,), ("model",), device=device)
    args = (torch.as_tensor(t, device=device) for t in (q, k, v))
    return t_ring.ring_attention(*args, mesh, "model", **kw)


# ---------------------------------------------------------------------------
# message path against the bare-permute path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("n_parts", [1, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_message_path_bitwise_matches_permute_path(coalesce, n_parts, causal):
    """skv = 4 with n_parts = 3 runs the clipped remainder tail (4 % 3)."""
    q, k, v = _qkv(8)
    want = _ring(8, q, k, v, comm="permute", n_parts=n_parts, causal=causal)
    got = _ring(8, q, k, v, comm="messages", n_parts=n_parts, packer="slice",
                coalesce=coalesce, causal=causal)
    assert torch.equal(got, want)


def test_kernel_packer_plain_path_bitwise_matches_slice():
    """The ``cuda`` packer on CPU tensors runs its plain version: bitwise
    the ``slice`` result (on the card: the ``cuda`` test below)."""
    q, k, v = _qkv(4, skv=5, seed=2)
    want = _ring(4, q, k, v, n_parts=3, packer="slice")
    for coalesce in (True, False):
        assert torch.equal(_ring(4, q, k, v, n_parts=3, packer="cuda", coalesce=coalesce), want)


@pytest.mark.parametrize("comm", ["messages", "permute"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_single_device_oracle(comm, causal):
    """The rotated ring on 4 ranks against JAX's plain softmax attention on
    the whole sequence."""
    q, k, v = _qkv(4, seed=3)
    got = _ring(4, q, k, v, comm=comm, causal=causal, n_parts=3)
    qg, kg, vg = (jnp.swapaxes(jnp.asarray(_global(t)), 1, 2) for t in (q, k, v))
    want = jnp.swapaxes(attention_ref(qg, kg, vg, causal=causal), 1, 2)
    np.testing.assert_allclose(_global(got.numpy()), np.asarray(want), **RING_TOL)


def test_partitioned_remainder_matches_unpartitioned():
    """skv = 5 in 3 partitions (widths 2, 2, 1) against n_parts = 1."""
    q, k, v = _qkv(4, skv=5, seed=7)
    want = _ring(4, q, k, v, comm="permute")
    got = _ring(4, q, k, v, comm="messages", n_parts=3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_bf16_wire_stays_within_tolerance():
    """Lossy wire: bf16 re-quantizes the circulating KV every hop."""
    q, k, v = _qkv(2, seed=11)
    want = _ring(2, q, k, v, comm="permute")
    got = _ring(2, q, k, v, packer="bf16")
    torch.testing.assert_close(got, want, rtol=4 / 128, atol=4 / 128)


def test_ring_of_one_is_local_attention():
    q, k, v = _qkv(1, seed=5)
    assert torch.equal(_ring(1, q, k, v), _ring(1, q, k, v, comm="permute"))


# ---------------------------------------------------------------------------
# against JAX ring_attention itself
# ---------------------------------------------------------------------------

JAX_CELLS = {
    "messages-causal": dict(comm="messages", causal=True),
    "messages-p3-noncausal": dict(comm="messages", n_parts=3, causal=False),
    "permute-p2-causal": dict(comm="permute", n_parts=2, causal=True),
}


@pytest.fixture(scope="module")
def jax_ring_cells():
    ring = 4
    q, k, v = _qkv(ring, skv=5, seed=13)
    mesh = j_compat.make_mesh((ring,), ("model",), devices=_jax_devices(ring))
    spec = P(None, "model", None, None)

    def inner(qb, kb, vb):
        return {name: j_ring.ring_attention(qb, kb, vb, "model", **kw)
                for name, kw in JAX_CELLS.items()}

    run = _jitr(j_compat.shard_map(inner, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
    out = run(*(jnp.asarray(_global(t)) for t in (q, k, v)))
    return (q, k, v), {name: np.asarray(x) for name, x in out.items()}


@pytest.mark.parametrize("name", sorted(JAX_CELLS))
def test_ring_attention_matches_jax(jax_ring_cells, name):
    (q, k, v), want = jax_ring_cells
    got = _ring(4, q, k, v, **JAX_CELLS[name])
    np.testing.assert_allclose(_global(got.numpy()), want[name], **RING_TOL)


def test_ring_kv_messages_equal_jax_table():
    for n_parts in (1, 3):
        got = t_ring.ring_kv_messages((2, B, 6, HKV, D), "model", 4, n_parts=n_parts)
        want = j_ring.ring_kv_messages((2, B, 6, HKV, D), "model", 4, n_parts=n_parts)
        assert [dataclasses.astuple(m) for m in got] == [dataclasses.astuple(m) for m in want]


# ---------------------------------------------------------------------------
# collectives a hop
# ---------------------------------------------------------------------------

MOVES: list[int] = []


@dataclasses.dataclass(frozen=True)
class CountingLoopback(LoopbackTransport):
    """``loopback`` that counts its moves (not registered)."""

    name: str = "counting-loopback"

    def start(self, buf, route, out=None):
        MOVES.append(1)
        return super().start(buf, route, out)


@pytest.mark.parametrize("kw,per_hop", [
    (dict(comm="messages", coalesce=True), 1),
    (dict(comm="messages", coalesce=False), 2),
    (dict(comm="messages", coalesce=True, n_parts=2), 2),
    (dict(comm="permute"), 2),
])
def test_collectives_per_hop(kw, per_hop):
    """K and V share one wire buffer a hop when coalesced: ring - 1 moves a
    call; uncoalesced or bare, K and V move apart (2x); partitioned and
    coalesced, one move a partition round (n_parts x)."""
    ring = 4
    q, k, v = _qkv(ring)
    MOVES.clear()
    _ring(ring, q, k, v, transport=CountingLoopback(), **kw)
    assert len(MOVES) == per_hop * (ring - 1)
    if kw["comm"] == "messages":
        msgs = t_ring.ring_kv_messages((2, B, 4, HKV, D), "model", ring,
                                       n_parts=kw.get("n_parts", 1))
        assert scheduled_collective_count([msgs], coalesce=kw["coalesce"]) == per_hop


def _plan_delta(before):
    from repro_torch.core.plan import PLANS

    return PLANS.stats.inits - before.inits, PLANS.stats.cache_hits - before.cache_hits


def test_kv_hop_is_a_persistent_plan_built_once_per_structure():
    """The KV hop's prepared exchange lives in the plan registry: built at
    the first call of a structure, started by every later call (the same
    result), and another ``n_parts`` is another plan."""
    from repro_torch.core.plan import PLANS
    from repro_torch.core.transport import PreparedExchange

    ring = 4
    q, k, v = _qkv(ring, skv=6, seed=9)
    PLANS.invalidate(lambda key: key[0] == "ring_kv")
    before = dataclasses.replace(PLANS.stats)
    first = _ring(ring, q, k, v, n_parts=3)
    assert _plan_delta(before) == (1, 0)
    assert torch.equal(_ring(ring, q, k, v, n_parts=3), first)
    assert _plan_delta(before) == (1, 1)
    _ring(ring, q, k, v, n_parts=2)
    assert _plan_delta(before) == (2, 1)
    plans = [PLANS._plans[key] for key in PLANS.keys() if key[0] == "ring_kv"]
    assert len(plans) == 2
    assert all(isinstance(p.exchange, PreparedExchange) and not p.captured for p in plans)


def test_permute_routes_are_plans_in_the_registry():
    """``Transport.permute`` builds a hop's route once, as an eager plan in
    the registry, and ranks receiving nothing get zeros."""
    from repro_torch.core.plan import PLANS

    mesh = make_mesh((4,), ("model",), device="cpu")
    x = torch.arange(8.0).view(4, 2)
    perm = ((0, 2), (1, 3))
    PLANS.invalidate(lambda key: key[0] == "permute")
    before = dataclasses.replace(PLANS.stats)
    for shift in (0.0, 1.0):
        got = LoopbackTransport().permute(x + shift, mesh, "model", perm)
        assert torch.equal(got, torch.cat([torch.zeros(2, 2), x[:2] + shift]))
    assert _plan_delta(before) == (1, 1)


# ---------------------------------------------------------------------------
# recurrent-state passing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_states():
    rng = np.random.default_rng(21)
    ring = 8
    C = rng.normal(size=(ring, 2, 3, 4)).astype(np.float32)
    Dd = rng.uniform(0.2, 1.0, size=(ring, 2, 3, 1)).astype(np.float32)
    mesh = j_compat.make_mesh((ring,), ("model",), devices=_jax_devices(ring))
    spec = P("model")

    def inner(c, d):
        return {m: j_ring.state_passing(c, d, "model", method=m) for m in ("ring", "tree")}

    run = _jitr(j_compat.shard_map(inner, mesh=mesh, in_specs=(spec, spec), out_specs=spec))
    out = run(jnp.asarray(C.reshape(-1, 3, 4)), jnp.asarray(Dd.reshape(-1, 3, 1)))
    return C, Dd, {m: np.asarray(x).reshape(C.shape) for m, x in out.items()}


@pytest.mark.parametrize("method", ["ring", "tree"])
def test_state_passing_matches_jax(jax_states, method):
    C, Dd, want = jax_states
    mesh = make_mesh((8,), ("model",), device="cpu")
    got = t_ring.state_passing(torch.from_numpy(C), torch.from_numpy(Dd), mesh, "model",
                               method=method)
    np.testing.assert_allclose(got.numpy(), want[method], rtol=1e-5, atol=1e-5)
    assert not got[0].any()  # the first shard starts from zeros


def test_state_passing_on_a_2d_mesh_runs_per_group():
    """On a (2, 4) mesh the state passes within each data group: each group
    equals the same call on its own 1-D mesh."""
    rng = np.random.default_rng(3)
    C = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    Dd = torch.from_numpy(rng.uniform(0.2, 1.0, size=(8, 3)).astype(np.float32))
    got = t_ring.state_passing(C, Dd, make_mesh((2, 4), ("data", "model"), device="cpu"),
                               "model", method="tree")
    line = make_mesh((4,), ("model",), device="cpu")
    for g in range(2):
        want = t_ring.state_passing(C[4 * g:4 * g + 4], Dd[4 * g:4 * g + 4], line, "model",
                                    method="tree")
        assert torch.equal(got[4 * g:4 * g + 4], want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_packer_ring_bitwise_matches_slice_on_the_card(cuda, dtype):
    """Every hop through ``copy_convert``/``gather_pack`` on the card equals
    the ``slice`` packer's plain copies bitwise, n_parts 1 and 3, coalesced
    or not."""
    q, k, v = (torch.as_tensor(t, device=cuda).to(dtype) for t in _qkv(8, skv=5, seed=17))
    mesh = make_mesh((8,), ("model",), device=cuda)
    for n_parts in (1, 3):
        want = t_ring.ring_attention(q, k, v, mesh, "model", n_parts=n_parts, packer="slice")
        for coalesce in (True, False):
            got = t_ring.ring_attention(q, k, v, mesh, "model", n_parts=n_parts, packer="cuda",
                                        coalesce=coalesce)
            assert torch.equal(got, want), (n_parts, coalesce)


# ---------------------------------------------------------------------------
# the pack kernels' host-side tables for the 5-D KV buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_parts", [1, 3])
def test_kv_wire_layouts_walk_equals_gather_ref(n_parts):
    """The ``cuda`` packer's work table of every coalesced KV round (local
    blocks of 5 dims, ``(2, B, Skv, Hkv, D)``), walked row by row as the
    gather kernel walks it, equals ``gather_pack_ref`` bitwise; and every
    window ``copy_convert`` packs or unpacks collapses to the kernel's 4
    dims."""
    from repro_torch.core.transport import schedule_layouts, window
    from repro_torch.kernels.pack.pack import _launch_layout, segment_rows, work_rows
    from repro_torch.kernels.pack.ref import gather_pack_ref

    local = (2, B, 5, HKV, D)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, *local)).astype(np.float32))
    msgs = t_ring.ring_kv_messages(local, "model", 3, n_parts=n_parts)
    for lay in schedule_layouts([msgs], "cuda", torch.float32):
        segs = tuple((s.offset, s.src_start, s.shape) for s in lay.segments)
        table = work_rows(tuple(map(tuple, segment_rows(segs, local))), local, 16)
        flat, got = x.reshape(3, -1), torch.empty((3, lay.total))
        for wire, src, rows, run, srow, *_ in table:
            for k in range(rows):
                got[:, wire + k * run:wire + (k + 1) * run] = flat[:, src + k * srow:
                                                                  src + k * srow + run]
        assert torch.equal(got, gather_pack_ref(x, segs, total=lay.total))
        for s in lay.segments:
            win = window(x, s.src_start, s.shape)
            _launch_layout(win.shape, win.stride(), torch.empty(win.shape).stride(), 4, 2)
