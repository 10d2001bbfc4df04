#!/usr/bin/env python3
"""Drive the PyTorch port's halo-exchange main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``).  It needs
one CUDA card; without one, or outside a checkout, it exits non-zero and
prints no result.  Every phase that fails ends the run with a non-zero exit.

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: the heat3d layout, a (4, 2) mesh over
   (pz, py) with x whole and a global interior of (1024, 1024, 512) f32, so
   each rank's ghosted block is (258, 514, 512).  Print each kernel's time
   (CUDA events, median), its plain version's time, its bound (bytes over
   3.35 TB/s) and one PyTorch call computing the same function.
3. Exchange matrix at full size: 5 strategies x 4 packers x coalesce on/off
   against the port's ``reference_exchange`` on the card (bitwise for the
   exact packers, within ``wire_tolerance`` for the lossy ones).
4. Heat3d through ``comb_measure`` (the main path): all five strategies,
   packer ``cuda``, coalesced, the ``stencil27`` kernel update.  Launch
   counts are zeroed just before and read just after; each kernel must have
   launched.  The cycles are checked against the same cycles run through
   packer ``slice`` with ``stencil27_ref`` on the card, and ``torch.profiler``
   shows where each strategy's cycle goes (device time by kernel, idle share).
5. Print the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.  The full record also goes to
   ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: H100 SXM data-sheet HBM3 rate, the bytes bound of every kernel here
HBM_BYTES_PER_S = 3.35e12
MESH = ((4, 2), ("pz", "py"))
GLOBAL_INTERIOR = (1024, 1024, 512)
#: stated tolerances.  Pack/unpack are elementwise converts: exact.  The
#: stencil rounds each product and sum like its plain version (no FMA), but
#: the check allows FMA-level differences: f32 rtol=1e-5, atol=1e-5; bf16
#: output one bf16 ulp (rtol=2^-7).
STENCIL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-6)}
HEAT_CYCLES, HEAT_REPEATS, VERIFY_CYCLES = 20, 3, 3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def short_kernel_name(name: str) -> str:
    """``void (anonymous namespace)::stencil27_kernel<float>(...)`` -> ``stencil27_kernel``."""
    if "direct_copy" in name:
        return "direct_copy"
    n = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return n.split("(")[0].split("<")[0].split("::")[-1].strip() or name[:40]


def time_ms(torch, fn, *, reps: int = 7, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events);
    ``flush`` runs before each launch, outside the events (cold L2)."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.transport import available_packers, get_packer
    from repro_torch.kernels import _build
    from repro_torch.kernels.pack import pack as pack_k
    from repro_torch.kernels.pack.ref import gather_pack_ref, pack_2d_ref, unpack_2d_ref
    from repro_torch.kernels.stencil27.ref import jacobi_weights, stencil27_ref
    from repro_torch.kernels.stencil27.stencil27 import stencil27
    from repro_torch.stencil import (
        Domain,
        StrategyConfig,
        available_strategies,
        comb_measure,
        make_driver,
        reference_exchange,
    )
    from repro_torch.stencil.comb import device_breakdown
    from repro_torch.stencil.heat3d import DOMAIN_AXES, heat3d_update

    record: dict = {}
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    smi = nvidia_smi_line()
    print(f"build: {sorted(libs)} in {build_s:.1f} s; card: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    record.update(build_s=build_s, card=smi, torch=torch.__version__, cuda=torch.version.cuda)

    mesh = make_mesh(*MESH, device=dev)
    dom = Domain(mesh, GLOBAL_INTERIOR, DOMAIN_AXES)
    ranks, local = mesh.size, dom.local_ghosted
    print(f"domain {GLOBAL_INTERIOR} on mesh {mesh.shape}: block {local} per rank, "
          f"faces {dom.face_bytes()} bytes", flush=True)
    x = dom.random(0)
    xb = x.view(ranks, *local)
    l2_flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    flush = l2_flush.zero_
    kernels: dict[str, dict] = {}

    def bound_ms(nbytes: int) -> float:
        return nbytes / HBM_BYTES_PER_S * 1e3

    # -- 2a. copy_convert (pack and unpack of strided face windows) --------
    worst = 0.0
    faces = {"pz": (slice(1, 2), slice(None)), "py": (slice(None), slice(1, 2))}
    for fname, (zs, ys) in faces.items():
        win = xb[:, zs, ys, :]
        for wire, scale in ((torch.float32, 1.0), (torch.bfloat16, 1.0), (torch.bfloat16, 8.0)):
            buf = torch.empty(win.shape, dtype=wire, device=dev)
            pack_k.copy_convert(win, buf, scale=scale)
            want = pack_2d_ref(win, out_dtype=wire, scale=scale)
            back = torch.zeros_like(xb)
            ghost = back[:, zs, ys, :]
            pack_k.copy_convert(buf, ghost, scale=1.0 / scale if scale != 1.0 else 1.0)
            want_back = unpack_2d_ref(want, out_dtype=torch.float32, scale=scale)
            torch.cuda.synchronize()
            err = max((buf.float() - want.float()).abs().max().item(),
                      (ghost - want_back).abs().max().item())
            if not (torch.equal(buf, want) and torch.equal(ghost, want_back)):
                fail(f"copy_convert {fname} {wire} scale={scale}: max err {err}")
            worst = max(worst, err)
            print(f"copy_convert {fname} face {tuple(win.shape)} f32->{str(wire)[6:]} "
                  f"scale={scale}: exact", flush=True)
            del back
    # timed case: the pz face f32 pack, as the main path packs it
    win = xb[:, 1:2, :, :]
    buf = torch.empty(win.shape, dtype=torch.float32, device=dev)
    nbytes = 2 * win.numel() * 4
    kernels["copy_convert"] = dict(
        name="copy_convert", route="cuda", source="src/repro_torch/kernels/csrc/pack.cu",
        replaces="src/repro/kernels/pack/pack.py:60", max_abs_err=worst,
        ms=time_ms(torch, lambda: pack_k.copy_convert(win, buf), flush=flush),
        plain_ms=time_ms(torch, lambda: buf.copy_(pack_2d_ref(win, out_dtype=torch.float32)), flush=flush),
        bound_ms=bound_ms(nbytes), bound_by="bytes",
        library_ms=time_ms(torch, lambda: buf.copy_(win.to(torch.float32)), flush=flush),
        shape=list(win.shape),
    )
    print("copy_convert:", json.dumps(kernels["copy_convert"]), flush=True)

    # -- 2b. gather_pack over the main path's coalesced layouts ------------
    worst, layouts = 0.0, []
    for name, n_parts in (("persistent", 1), ("partitioned", 4), ("fused", 1)):
        drv = make_driver(StrategyConfig(name=name, n_parts=n_parts, packer="cuda"),
                          mesh, dom.halo_spec, ndim=3)
        layouts += list(drv.wire_layouts(x))
    for lay in layouts:
        table = pack_k.segment_table(lay.segments, local, dev)
        for wire in (torch.float32, torch.bfloat16):
            out = torch.empty((ranks, lay.total), dtype=wire, device=dev)
            pack_k.gather_pack(xb, table, out)
            want = gather_pack_ref(xb, lay.segments, total=lay.total, out_dtype=wire)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            if not torch.equal(out, want):
                fail(f"gather_pack {lay.hops and lay.hops[0][0]} total={lay.total} {wire}: err {err}")
            worst = max(worst, err)
    print(f"gather_pack: {len(layouts)} layouts x (f32, bf16) wire exact", flush=True)
    lay = max(layouts, key=lambda la: (len(la.segments), la.total))
    table = pack_k.segment_table(lay.segments, local, dev)
    out = torch.empty((ranks, lay.total), dtype=torch.float32, device=dev)
    ids = torch.arange(math.prod(local), device=dev).view(local)
    flat_idx = torch.cat([
        ids[tuple(slice(b, b + n) for b, n in zip(s.src_start, s.shape))].reshape(-1)
        for s in lay.segments
    ])
    del ids
    xflat = xb.reshape(ranks, -1)
    torch.cuda.synchronize()
    if not torch.equal(torch.index_select(xflat, 1, flat_idx), gather_pack_ref(xb, lay.segments, total=lay.total)):
        fail("gather_pack library yardstick gathers other elements")
    kernels["gather_pack"] = dict(
        name="gather_pack", route="cuda", source="src/repro_torch/kernels/csrc/pack.cu",
        replaces="src/repro/kernels/pack/pack.py:112", max_abs_err=worst,
        ms=time_ms(torch, lambda: pack_k.gather_pack(xb, table, out), flush=flush),
        plain_ms=time_ms(torch, lambda: gather_pack_ref(xb, lay.segments, total=lay.total), flush=flush),
        bound_ms=bound_ms(2 * ranks * lay.total * 4), bound_by="bytes",
        library_ms=time_ms(torch, lambda: torch.index_select(xflat, 1, flat_idx), flush=flush),
        segments=len(lay.segments), total=lay.total,
    )
    print("gather_pack:", json.dumps(kernels["gather_pack"]), flush=True)

    # -- 2c. stencil27 at the heat3d update's shapes ------------------------
    w = jacobi_weights(device=dev)
    wr = torch.randn((3, 3, 3), generator=torch.Generator(dev).manual_seed(5), device=dev)
    worst = 0.0
    xp = torch.cat([xb[..., -1:], xb, xb[..., :1]], dim=-1)  # (8, 258, 514, 514)
    cases = [("update f32", xp, wr), ("update bf16", xp.to(torch.bfloat16), wr),
             ("z shell f32", xp[:, :3].contiguous(), wr),
             ("y shell f32", xp[:, :, :3].contiguous(), wr),
             ("jacobi f32", xp, w)]
    for label, inp, weights in cases:
        outk = torch.empty((ranks, *(s - 2 for s in inp.shape[1:])), dtype=inp.dtype, device=dev)
        stencil27(inp, weights, outk)
        want = stencil27_ref(inp, weights)
        torch.cuda.synchronize()
        rtol, atol = STENCIL_TOL[str(inp.dtype)[6:]]
        err = (outk.float() - want.float()).abs().max().item()
        if not torch.isfinite(outk.float()).all() or not torch.allclose(
                outk.float(), want.float(), rtol=rtol, atol=atol):
            fail(f"stencil27 {label} {tuple(inp.shape)}: max abs err {err}")
        worst = max(worst, err)
        print(f"stencil27 {label} {tuple(inp.shape)}: max abs err {err} "
              f"(bitwise {torch.equal(outk, want)})", flush=True)
        del outk, want
    outk = torch.empty((ranks, *(s - 2 for s in xp.shape[1:])), dtype=xp.dtype, device=dev)
    conv_w = wr.view(1, 1, 3, 3, 3)
    xp5 = xp.unsqueeze(1)
    conv = F.conv3d(xp5, conv_w)
    torch.cuda.synchronize()
    conv_err = (conv.view_as(outk) - stencil27_ref(xp, wr)).abs().max().item()
    del conv
    kernels["stencil27"] = dict(
        name="stencil27", route="cuda", source="src/repro_torch/kernels/csrc/stencil27.cu",
        replaces="src/repro/kernels/stencil27/stencil27.py:67", max_abs_err=worst,
        ms=time_ms(torch, lambda: stencil27(xp, wr, outk)),
        plain_ms=time_ms(torch, lambda: stencil27_ref(xp, wr), reps=3),
        bound_ms=bound_ms((xp.numel() + outk.numel()) * 4), bound_by="bytes",
        library_ms=time_ms(torch, lambda: F.conv3d(xp5, conv_w), reps=3),
        library_max_abs_err=conv_err, shape=list(xp.shape),
    )
    print("stencil27:", json.dumps(kernels["stencil27"]), flush=True)
    del xp, xp5, outk, cases, x, xb
    torch.cuda.empty_cache()

    # -- 3. exchange matrix at full size ------------------------------------
    interior = torch.randn(GLOBAL_INTERIOR, generator=torch.Generator(dev).manual_seed(1), device=dev)
    want = reference_exchange(dom, interior)
    cells = 0
    for name in available_strategies():
        for packer in available_packers():
            for coalesce in (True, False):
                drv = make_driver(StrategyConfig(name=name, packer=packer, coalesce=coalesce,
                                                 n_parts=4 if name == "partitioned" else 1),
                                  mesh, dom.halo_spec, ndim=3)
                got = drv.wait(drv.step(dom.from_global_interior(interior)))
                drv.free()
                rtol, atol = get_packer(packer).wire_tolerance(dom.dtype)
                ok = (torch.equal(got, want) if rtol == atol == 0.0
                      else bool(torch.isclose(got, want, rtol=rtol, atol=atol).all()))
                if not ok:
                    fail(f"exchange {name} {packer} coalesce={coalesce} differs from reference_exchange")
                cells += 1
                del got
    print(f"exchange matrix: {cells} cells (5 strategies x {len(available_packers())} packers "
          f"x coalesce) equal reference_exchange (bitwise for exact packers)", flush=True)
    del want
    torch.cuda.empty_cache()

    # -- 4. heat3d through comb_measure: the main path ----------------------
    weights = jacobi_weights().numpy()
    update = heat3d_update(weights, dev)
    strategies = ("standard", "persistent", "partitioned", "fused", "overlap")
    _build.reset_launches()
    results, per_cycle = {}, {}
    for name in strategies:
        before = dict(_build.LAUNCHES)
        res = comb_measure(dom, strategies=(StrategyConfig(
            name=name, packer="cuda", coalesce=True, n_parts=4 if name == "partitioned" else 1),),
            update_fn=update, n_cycles=HEAT_CYCLES, repeats=HEAT_REPEATS, seed=0)
        (label, r), = res.items()
        cycles = 3 + HEAT_CYCLES * HEAT_REPEATS  # run_cycles' warmup + timed
        per_cycle[name] = {k: (v - before.get(k, 0)) / cycles for k, v in _build.LAUNCHES.items()}
        results[label] = r
        print(f"heat3d {label}: us_per_cycle={r.us_per_cycle:.1f} init_us={r.init_us:.1f} "
              f"collective_count={r.collective_count} launches/cycle={per_cycle[name]} "
              f"checksum={r.checksum!r} device={r.device}", flush=True)
    launches = dict(_build.LAUNCHES)
    print("launches on the main path:", json.dumps(launches), flush=True)
    for kname in ("copy_convert", "gather_pack", "stencil27"):
        if launches.get(kname, 0) <= 0:
            fail(f"kernel {kname} was not launched on the main path")
        kernels[kname]["launches"] = launches[kname]
    ref_sum = next(iter(results.values())).checksum
    for label, r in results.items():
        if not math.isfinite(r.checksum) or abs(r.checksum - ref_sum) >= 1e-3 + 1e-3 * abs(ref_sum):
            fail(f"heat3d {label} checksum {r.checksum} diverged from {ref_sum}")

    # the same cycles through packer `slice` and the plain stencil
    plain = make_driver(StrategyConfig(name="persistent", packer="slice"), mesh, dom.halo_spec,
                        ndim=3, update_fn=heat3d_update(weights, dev, stencil=stencil27_ref))
    ref_x = dom.random(2)
    for _ in range(VERIFY_CYCLES):
        ref_x = plain.step(ref_x)
    ref_x = plain.wait(ref_x)
    plain.free()
    rtol, atol = STENCIL_TOL["float32"]
    breakdown = {}
    for name in strategies:
        drv = make_driver(StrategyConfig(name=name, packer="cuda", n_parts=4 if name == "partitioned" else 1),
                          mesh, dom.halo_spec, ndim=3, update_fn=update)
        y = dom.random(2)
        for _ in range(VERIFY_CYCLES):
            y = drv.step(y)
        y = drv.wait(y)
        if not torch.isfinite(y).all() or not torch.allclose(y, ref_x, rtol=rtol, atol=atol):
            fail(f"heat3d {name}: {VERIFY_CYCLES} cycles differ from the slice + stencil27_ref cycles "
                 f"(max abs err {(y - ref_x).abs().max().item()})")
        print(f"heat3d {name}: {VERIFY_CYCLES} cycles match slice + stencil27_ref "
              f"(max abs err {(y - ref_x).abs().max().item()})", flush=True)
        # where the cycle's time goes (torch.profiler, 3 traced cycles)
        b = breakdown[name] = device_breakdown(drv, y)
        drv.free()
        del y
        top = ", ".join(f"{short_kernel_name(k['name'])} x{k['launches_per_cycle']:g} "
                        f"{k['us_per_cycle']:.0f}us"
                        for k in b["kernels"][:6])
        print(f"heat3d {name} breakdown: window {b['window_us_per_cycle']:.0f} us/cycle, "
              f"device busy {b['busy_us_per_cycle']:.0f} us, idle share {b['idle_share']:.3f}; "
              f"{top}", flush=True)

    # -- 5. results -----------------------------------------------------------
    record.update(
        kernels=list(kernels.values()),
        heat3d={label: r.record() for label, r in results.items()},
        launches_per_cycle=per_cycle, exchange_cells=cells, breakdown=breakdown,
    )
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in kernels.values()]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
