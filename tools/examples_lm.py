"""Phase P of ``chip_smoke.py``: the port's examples on the card, each run
in this process through its ``main(argv)`` at its defaults.

* P1 ``examples/quickstart_torch.py``: reduced llama3-8b (head dim 16)
  trained 30 steps through the ``Trainer`` (flash forward and backward),
  its loss asserted to fall, then 8 tokens served (the prefill's flash
  forward, decode steps on CUDA graphs).
* P2 ``examples/serve_batched_torch.py``: 12 requests of 4-23 tokens, 4
  slots, 16 new tokens each, on stablelm-1.6b at width 128, 4 layers, head
  dim 32; then ``--full``, stablelm-1.6b at full width (1.64 B
  parameters).  Held: 12 prefills, every request 16 tokens of the
  vocabulary, 12 x 15 decode tokens.
* P3 ``examples/long_context_ring_torch.py`` at ``--seq 512`` (its
  defaults) and at ``--seq 4096``: causal ring attention on 8 stacked
  sequence shards, and reduced zamba2's sequence-parallel loss asserted
  within 2e-2 of its local loss (the example's own check; the local loss
  runs the flash forward).  The example packs with ``slice``, as JAX's
  does; phases H and N3 hold the pack kernels on the ring paths.

Each example's exception or failed assert fails the phase.  The kernels'
launches of each run are recorded (``_build.LAUNCHES`` set to 0 before,
read after), and the plans they made are freed after the last.
``chip_smoke.py`` calls :func:`examples_phase` after phase
A; alone::

    PYTHONPATH=src python3 tools/examples_lm.py
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNS = (("P1", "quickstart_torch", []),
        ("P2", "serve_batched_torch", []),
        ("P2", "serve_batched_torch", ["--full"]),
        ("P3", "long_context_ring_torch", ["--seq", "512"]),
        ("P3", "long_context_ring_torch", ["--seq", "4096"]))
#: the kernels each example's path must launch
MUST_LAUNCH = {"P1": ("flash_attention", "flash_attention_bwd"),
               "P2": ("flash_attention",),
               "P3": ("flash_attention",)}


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(name: str, argv: list, res: dict) -> tuple[dict, list[str]]:
    """What a run's result shows, and what it got wrong."""
    bad: list[str] = []
    if name == "quickstart_torch":
        st = res["stats"]
        out = dict(losses=res["losses"], tokens=res["tokens"], plan_inits=st.plan_inits,
                   plan_hits=st.plan_hits)
        if len(res["tokens"]) != 8:
            bad.append(f"{len(res['tokens'])} tokens generated, want 8")
    elif name == "serve_batched_torch":
        st = res["stats"]
        out = dict(params=res["params"], seconds=res["seconds"],
                   tokens_per_s=st.tokens_generated / res["seconds"], prefills=st.prefills,
                   decode_steps=st.decode_steps, tokens_generated=st.tokens_generated,
                   plan_inits=st.plan_inits, plan_hits=st.plan_hits,
                   first_tokens=[res["results"][u][:4] for u in res["uids"][:4]])
        lens = [len(res["results"][u]) for u in res["uids"]]
        if st.prefills != 12 or st.tokens_generated != 12 * 15 or set(lens) != {16}:
            bad.append(f"{st.prefills} prefills, {st.tokens_generated} decode tokens, "
                       f"lengths {lens}")
    else:
        out = dict(ms_a_call={str(k): v for k, v in res["ms"].items()},
                   loss_local=res["loss_local"], loss_seqp=res["loss_seqp"],
                   finite=all(bool(o.isfinite().all()) for o in res["ring"].values()))
        if not out["finite"]:
            bad.append("ring attention output not finite")
    return out, bad


def examples_phase(torch, dev) -> dict:
    """P1-P3; raises ``RuntimeError`` after every run when one failed."""
    from repro_torch.core.plan import PLANS
    from repro_torch.kernels import _build

    fails: list[str] = []
    out: dict = {"runs": [], "launches": {}}
    kept = set(PLANS.keys())
    for path, name, argv in RUNS:
        label = f"{path} {name} {' '.join(argv)}".strip()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            res = _example(name).main(argv)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - every run is reported, then the phase fails
            fails.append(f"{label}: {type(e).__name__}: {e}")
            print(f"{label}: FAILED {type(e).__name__}: {e}", flush=True)
            continue
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        summary, bad = _summary(name, argv, res)
        fails += [f"{label}: {b}" for b in bad]
        by = out["launches"].setdefault(path, {})
        for k, n in launches.items():
            by[k] = by.get(k, 0) + n
        run = dict(path=path, example=name, argv=argv, wall_s=wall, launches=launches, **summary)
        out["runs"].append(run)
        print(f"{label}: {json.dumps(run)}", flush=True)
        del res
    # the examples' plans go with them: later phases read the registry as
    # holding their own (phase H checks every ring KV plan on its mesh)
    for key in set(PLANS.keys()) - kept:
        PLANS.discard(key)
    for path, names in MUST_LAUNCH.items():
        for k in names:
            if not out["launches"].get(path, {}).get(k):
                fails.append(f"{path} never launched {k}")
    out["failures"] = fails
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("examples_lm: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    _build.build_all(verbose=True)
    try:
        out = examples_phase(torch, torch.device("cuda", 0))
    except RuntimeError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    print(json.dumps(out["launches"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
