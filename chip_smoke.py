#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU: the halo
exchange (heat3d), its §VI sweep, its multi-process grid and its elastic
recovery, llama3-8b serving and rwkv6-1.6b serving, both models
sequence-parallel on a virtual ring of 8 ranks, the MoE model:
phi3.5-moe served and expert-parallel over 16 ranks, one grok-1 MoE FFN,
the LM serve bench with the collective count of its ring prefill, and the
last model families: zamba2-1.2b served and sequence-parallel,
llama-3.2-vision-11b served, hubert-xlarge's encoder, and training:
stablelm-1.6b at full width through the flash-attention backward kernel,
rwkv6-1.6b at full width through the WKV backward kernel, the moe,
hybrid, vlm and audio families, and stablelm-1.6b data-parallel with
ZeRO-1 moments on a mesh of stacked ranks, restarted onto a smaller one,
with gradients through the ring paths, phi3.5-moe with its expert stacks
split over the data ranks (FSDP), and the examples (quickstart, batched
serving, long-context ring) at their defaults.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``).  It needs
one CUDA card; without one, or outside a checkout, it exits non-zero and
prints no result.  Every phase that fails ends the run with a non-zero exit.

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (``copy_convert`` also on a misaligned
   window, its scalar path, and an aligned one with a ragged run, its
   vector path's tail; ``gather_pack`` also on ragged, misaligned, x-face
   and corner segments; ``stencil27`` also into the strided interior window
   of a block, the main path's form, with its ghosts left alone): the
   heat3d layout, a (4, 2) mesh over
   (pz, py) with x whole and a global interior of (1024, 1024, 512) f32, so
   each rank's ghosted block is (258, 514, 512).  Print each kernel's time
   (CUDA events around one call, median, the pack kernels after an L2
   flush; the pack kernels and ``stencil27`` also by ``torch.profiler``'s
   device time), its plain version's time, its bound (bytes over 3.35
   TB/s) and one PyTorch call computing the same function.
3. Exchange matrix at full size: 5 strategies x 4 packers x coalesce on/off
   against the port's ``reference_exchange`` on the card (bitwise for the
   exact packers, within ``wire_tolerance`` for the lossy ones).
4. Heat3d through ``comb_measure`` (the main path): all five strategies,
   packer ``cuda``, coalesced, the ``stencil27`` kernel update; every
   strategy but ``standard`` replays the CUDA graph its plan captured at
   init.  Launch counts (replays included) are zeroed just before and read
   just after; each kernel must have launched.  The cycles are checked
   against the same cycles run through packer ``slice`` with
   ``stencil27_ref`` on the card, and each graph strategy's cycles bitwise
   against its plan's eager step (``plan.fn``); eager and graph are timed
   in turns (``tools/time_plan_graph.py``'s helpers: 20-cycle windows, host
   clock), and ``torch.profiler`` shows where each one's cycle goes (device
   time by kernel, idle share, the ``direct_copy`` launches left: the
   stencil writes the interior itself).
A. ``flash_attention`` against its plain version on the card at the shapes
   the serving path gives it (llama3-8b prefill, causal, bf16, S in
   {8, 128, 1000, 2048}; an MHA head_dim-64 case causal and not; an f32
   case, the CUDA-core route; a strided ragged q; Sq > Skv causal; Sq !=
   Skv non-causal); at S = 2048 also held to FLASH_REL_TOL in relative
   norm against the plain version in f32, a bound that a planted fault (one
   kv tile skipped, computed in plain PyTorch) must exceed; timed at
   S = 2048 beside the plain version and
   ``F.scaled_dot_product_attention`` (the library yardstick, never on the
   path): 20 back-to-back launches between one pair of CUDA events, and
   one launch as in earlier runs.  Then the last families' shapes:
   hubert-xlarge's encoder (B 4, S 1000, 16 heads of 80, non-causal, bf16
   and f32; the bf16 route also held to FLASH_REL_TOL against a planted
   skipped kv tile, and timed beside the plain version and SDPA),
   llama-3.2-vision's cross attention (512 queries on 1601 vision tokens,
   32 heads on 8 of 128, non-causal) and zamba2's shared block (32 heads of
   64, causal, S 2048).  Then head dims 16 and 32 (``tools/flash_head_dims.
   py``: the reduced configs' and the examples', on the 64-wide tile
   zero-filled past D): forward and backward, bf16 and f32, causal and
   not, GQA 4 on 2, against the plain version, at two ragged shapes, every
   shape phase P gives the kernels and 2 x 4096 tokens; and timed (forward
   and backward, bf16 causal, at P1's training shape, P2's 32-token
   prefill and 2 x 4096 tokens) beside the plain version and SDPA, with
   the bound of ``kernels/costs.py``.
P. The examples (``tools/examples_lm.py``), after phase A, each through
   its ``main(argv)`` at its defaults: (P1) ``examples/quickstart_torch.
   py``, reduced llama3-8b (head dim 16) trained 30 steps and its loss
   held to fall, then 8 tokens served; (P2) ``serve_batched_torch.py``, 12
   requests on stablelm-1.6b at width 128 (head dim 32), then ``--full``
   (1.64 B parameters), the engine's counts held; (P3)
   ``long_context_ring_torch.py`` at ``--seq 512`` and at ``--seq 4096``:
   ring attention on 8 stacked shards, and zamba2's sequence-parallel loss
   held within 2e-2 of its local one.  The flash forward's and backward's
   launches join the summary line's under ``"P"``, and each must have
   launched there.
B. Serving llama3-8b at full width and depth (random bf16 weights from
   ``torch.Generator`` seed 0, about 16.1 GB on the card) through
   ``ServingEngine(max_slots=4, max_len=2048)``: 8 requests of 5-2000
   prompt tokens, 16 new tokens each.  Launch counts are zeroed just
   before and read just after: ``flash_attention`` must launch 32 times
   per prefill, and the engine must init one plan per prefill bucket plus
   one decode plan.  The tokens are held against the same engine with the
   plain attention injected: equal, or, where they first differ, a near
   tie in the plain model's logits.  The decode plan alone captures a CUDA
   graph (prefill stays eager); the same requests with the decode step
   eager must give equal tokens.  Prints prefill ms per bucket, decode ms
   per step eager (``plan.fn``) and graph (``plan.start``) in turns,
   tokens per second, and the device idle share of a prefill and of an
   eager and a graph decode step (``torch.profiler``).
C. ``wkv_chunked`` against its plain version ``wkv_plain`` on the card at
   the shapes the rwkv6-1.6b serving path gives it, H = 32 heads of 64:
   f32 prefill with batch 1 and T in {5, 17, 37, 64, 128, 2048} (chunk
   min(64, T): ragged chunks pad to 16-row sub-blocks), f32 decode with
   batch 4, T = 1 and a random starting state (the decode route), a bf16
   case, a strong-decay case (log decay -12) and the model's two decay
   clamp ends (-exp(4), -exp(-8); prefill and decode, held against the
   plain version in float64, whose float32 run rounds cum - lw by more
   than the tolerance at -exp(4)), every output finite; the final state
   is held against the plain version's too.  Timed at prefill T = 2048 and
   at decode batch 4: CUDA events around one call (``ms``), 20
   back-to-back calls between one pair of events (``ms_batched``),
   ``torch.profiler``'s device time (``device_ms``) and the host time of a
   call (``host_us``), beside the plain version, the exponentials a head
   per chunk (the pairwise form in every column tile, as the first port
   took them, and the factored kernel's) and, beside the bound, the bound
   of the factored form's operation count (``bound_factored_ms``) with the
   device time's ratio to each; no single PyTorch call computes WKV, so
   there is no library yardstick.
D. Serving rwkv6-1.6b at full width and depth (random bf16 weights from
   ``torch.Generator`` seed 0, about 3.2 GB; the llama3-8b weights of phase
   B are freed first) through ``ServingEngine(max_slots=4, max_len=4096)``:
   8 prompts of 5, 12, 64, 128, 512, 1024, 1536 and 2048 tokens (lengths
   the reference's scan accepts), 16 new tokens each.  Launch counts are
   zeroed just before and read just after: ``wkv_chunked`` must launch 24
   times per prefill and 24 times per decode step (graph replays), and 24
   times for the decode plan's eager warm-up at init, and the engine must
   init one plan per prompt length (exact-length prefill) plus one decode
   plan, the one plan that captures; the same requests with the decode
   step eager must give equal tokens.
   The kernel is held against ``wkv_plain`` on the path's own inputs: every
   layer's scan of each prompt's prefill and of a decode step (3e-4).  The
   tokens are compared with the same engine with ``wkv_plain`` injected,
   twice: with the bf16 weights, reported only (the random bf16 model
   carries the scan's f32-level differences into logit differences of
   several tenths, larger than the gaps between its top tokens), and with
   the same weights in f32, held: equal, or a near tie at the first
   difference (1e-4 x (1 + |logit|)), and the prefill token must agree.
   Prints prefill ms per length, decode ms per step eager and graph in
   turns, tokens per second, and the device idle share of the 2048-token
   prefill and of an eager and a graph decode step.
E. The paper's §VI sweep on the card (``repro_torch.stencil.sweep``):
   (1) the smoke grid (4 ranks on a (2, 2) torus, all five strategies, all
   four packers, coalesce on and off, mappings row-major and blocked) on
   the card and then on the CPU: each pair of records must agree on
   ``collective_count``, ``wire_bytes``, ``message_bytes`` and the
   intra/inter-node sends, and the exact packers' checksums bitwise (the
   state is drawn on the host from the seed, so both start equal);
   (2) the card grid, written to ``chiprun_out/BENCH_torch_stencil_sweep.json``:
   4 and 8 ranks on (2, 2) and (4, 2) meshes, global interiors 64^3,
   256^3 and (1024, 1024, 512) f32 with halo 1 (largest face messages of
   8.7 KB, 133 KB and 1.05 MB at 8 ranks), all five strategies, packers
   ``slice`` and ``cuda``, coalesce off and on, ``n_parts`` 1, 2 and 4,
   200 cycles x 3 repeats, every plan strategy on its CUDA graph.  Launch
   counts are zeroed just before each
   cell's run and read just after (``run_cycles`` wrapped): every ``cuda``
   cell must launch ``copy_convert``, every coalesced one ``gather_pack``
   too, and a ``slice`` cell neither; every cell's last block must equal
   its slab's first cell's (``standard``, ``slice``) bitwise (checked by
   ``comb_measure``), and every ``cuda`` cell's checksum its ``slice``
   twin's; ``summarize``'s rows and a table of the
   best cell per strategy, size, packer and coalesce mode are printed;
   (3) ``StrategyConfig(name="auto", packer="auto", coalesce="auto")`` at
   the heat3d layout with the ``stencil27`` update, three times: with the
   grid just written as the trace (must resolve by ``trace`` to the
   argmin of ``us_per_cycle`` over that cell's records), with no trace and
   a fresh cache (``calibration``), and again on that cache (``cache``, the
   same candidate); each auto driver's cycles must be bitwise-equal to the
   resolved static driver's on the same seed.
F. The paper's process axis on the one card: (1) a grid of 2 processes
   (``repro_torch.launch.stencil.launch_grid``, gloo, both on ``cuda:0``)
   at the heat3d layout, 4 ranks a process, ``pz`` crossing the process
   boundary; in each process all five strategies with packer ``cuda``,
   coalesced (``partitioned`` p4), through the ``multihost`` transport
   (pack on the card, pinned host staging, gloo, unpack on the card; plans
   eager): rows bitwise-equal to ``reference_exchange`` at 64^3 and to a
   one-process ``loopback`` run of the same seeded block at full size,
   ``copy_convert`` and ``gather_pack`` launched in both processes, no
   plan captured; per strategy ``us_per_cycle`` beside phase E's
   one-process cell, the host staging's share of a cycle (d2h, gloo, h2d)
   and the intra/inter-node sends (a node is a process: real crossings);
   (2) phase E's 8-rank slab with ``processes=2`` (three sizes, five
   strategies, ``slice``/``cuda``, coalesce off/on, ``n_parts`` 1 and 4,
   30 x 3 cycles) written to ``chiprun_out/BENCH_torch_stencil_sweep_p2.json``
   (copied to the repository root and committed), its exact cells'
   checksums within 1e-12 of the one-process grid's.  A failed rank fails
   the run.
G. Elastic recovery (``repro_torch.launch.elastic``) at the heat3d size,
   ``(1024, 1024, 512)`` f32 on the runner's 1-axis mesh ``("px",)`` (8
   ranks: blocks of ``(130, 1024, 512)``, faces of 2 MiB, a 2 GiB
   checkpoint, ``keep=3``, each leg's directory under ``build/`` deleted
   after it), packer ``cuda``, coalesced, ``persistent`` (in one process
   on its CUDA graph), 8 steps, every leg's final interior bitwise-equal
   to the 1-rank oracle (``checkpoint_every=0``); launch counts zeroed
   before each leg and read after it, ``copy_convert`` and ``gather_pack``
   launched in every leg: (G1) 8 ranks, a checkpoint every 4 steps, a
   ``"mid-exchange"`` failure at step 5 (the step's graph replay still in
   flight), 4 survivors resume from step 4, the dead plan counted as an
   invalidation; (G2) the same in ``recovery_mode="in-grid"``, every
   membership operation through a live ``MembershipServer`` /
   ``MembershipClient`` on 127.0.0.1, an unrelated plan warmed beforehand
   kept, ``warm_ranks == 4``, ``plan_cache_inits`` growing; (G3) 4 ranks
   grow to 8 at step 3 with no checkpoint, the live state moved by
   ``reshard_state`` on the device; (G4) ``launch_grid(check=False)``
   runs 2 processes x 4 ranks (``multihost``, ``max_replans=0``, plans
   eager), process 1 fails mid-exchange at step 4 with a checkpoint every
   3 steps, the grid must die with step 3's commit intact, then one
   process with 4 ranks resumes from it on its graph.  After each recovery
   the dead plan's memory must have come back (``memory_allocated`` at
   the raise, once released, and after the first step on the new mesh).
   Prints each leg's events (``replan_us``, ``init_us`` with the capture,
   invalidations, epoch), checkpoint save and restore seconds, the time
   to recover, ``join_us``, ``warm_ranks``, the plan-cache counters and
   the launches; writes the four ``bench_record()`` rows with the card's
   name and power limit to ``chiprun_out/BENCH_torch_elastic.json``
   (copied to the repository root and committed).
H. The partitioned pipeline on the LM side (``tools/ring_lm.py``), at the
   end of phase B and of phase D on the weights already on the card, on a
   ``(1, 8)`` ``VirtualMesh`` over ``("data", "model")``: (H1) the phase B
   requests through ``ServingEngine`` under ``seq_parallel=True``,
   ``comm_packer="cuda"``, coalesced, at ``n_parts`` 1 and 4 (ring
   attention in every prefill): ``gather_pack`` and ``copy_convert``
   launches equal to layers x 7 hops x rounds (one gather and two copies a
   round), no ``flash_attention`` launch, tokens equal to phase B's local
   engine or a near tie at the first difference; at every KV hop the
   serves ran (each bucket and ``n_parts``), ``gather_pack`` bitwise
   against ``gather_pack_ref``, each ``copy_convert`` unpack window
   against ``unpack_2d_ref`` and the hop against the ring shift; the
   2048-token prefill's logits with packer ``cuda`` bitwise equal to
   packer ``slice``'s, and within ``ring_lm.RING_REL_TOL`` (relative L2)
   of the local prefill while a planted fault (rank 0's KV block left out
   of the other ranks' attention) reads above it, prefill ms in turns (the
   KV hop's kept plan against one built each call) and the exchange
   kernels' share of the ring prefill's device time; (H2) llama3-8b
   ``logits`` with ``tp_mode="ring"`` on 512 tokens within
   ``ring_lm.TP_RING_REL_TOL`` of the local logits, which a planted fault
   (each block's own partial product left out) must exceed; (H3)
   rwkv6-1.6b ``logits`` at T = 2048 with ``state_method`` ``ring`` and
   ``tree`` against the local model (f32 weights held within
   ``ring_lm.RWKV_F32_REL_TOL``, which planted faults must exceed: no
   state passed, and with slow decays, where a segment's D is O(1), D
   dropped; bf16 reported), ``state_passing`` alone at the model's state
   against a sequential f64 composition, ``wkv_chunked`` launched
   2 x 24 times a call, and ``message_all_to_all`` bitwise against
   ``partitioned_all_to_all`` for packers ``slice`` and ``cuda``, coalesced
   or not, ``n_parts`` 1 and 4.  Their launches join the summary line's
   (``launches_by_path``).
I. The MoE model (``tools/moe_lm.py``), after phase D, on a ``(1, 16)``
   ``VirtualMesh`` over ``("data", "model")`` where expert-parallel: (I1)
   phi3.5-moe at full width, 8 of its 32 layers (random bf16 weights from
   seed 0, 21 GB; 16 layers until phase O joined), served through
   ``ServingEngine(max_slots=4, max_len=2048)`` under the local context:
   phase B's 8 requests, each prefilled at its exact length, 16 new
   tokens; ``flash_attention`` launched once a layer a prefill, the
   dropless decode step the captured
   graph; tokens against a plain-attention engine (equal or a near tie)
   and against the eager decode (equal); prefill ms at 2000 tokens, decode
   ms eager and graph beside the weights' bytes floor, tokens per second,
   the share of (token, choice) pairs dropped at ``capacity_factor`` 1.25.
   (I2) one 2048-token prompt's logits under ``moe_mode="ep"`` with
   ``moe_comm`` ``native``, ``messages`` ``slice`` and ``messages`` ``cuda``
   (coalesced) at ``n_parts`` 1 and 4: bitwise equal at each ``n_parts``;
   ``gather_pack`` and each ``copy_convert`` window bitwise against their
   plain versions at every exchange of the ``cuda`` runs, launches equal to
   layers x 2 x ``n_parts`` x 16; at no-drop capacity within
   ``moe_lm.EP_REL_TOL`` of the local model, which a planted fault (one
   slot's expert output left out) must exceed; local and EP timed in turns
   with idle and exchange shares.  (I3) one grok-1 MoE FFN at full width
   (16 half-width slots, 9.7 GB) with the grouped psum: ``native`` and
   ``messages`` ``cuda`` bitwise equal, within ``moe_lm.GROK_REL_TOL`` of
   ``_moe_dense`` at no-drop capacity, which a planted fault (the partner
   slot left out of the psum) must exceed.  The weights are freed before
   phase E.  Its launches join the summary line's (``launches_by_path``).
J. The LM serve bench and the paper's communication accounting
   (``tools/serve_bench_lm.py``), after phase I: (J1)
   ``repro_torch.serving.bench``'s CLI at the full width of stablelm-1.6b
   (random bf16 weights from seed 0, 3.3 GB) on the ``(1, 8)`` ring, 6
   requests of 1025-2040 prompt tokens (one 2048 bucket), 2 slots, 8 new
   tokens, ``max_len`` 2048: ``--out`` (the three cells), ``--out
   --trace`` on that file (adds the ``auto`` cell), then ``--check``
   against it, which must pass with its ``auto`` cell replaying the trace
   cell; the file is ``chiprun_out/BENCH_torch_lm_serve.json`` (copied to
   the repository root and committed).  Every serve's tokens equal; tokens
   against a local engine on the same weights, equal or a near tie; the
   pack kernels counted from 0 at each serve, layers x 7 hops a prefill in
   a ``bf16`` cell, none in a ``slice`` cell; ``gather_pack`` and each
   ``copy_convert`` window bitwise against their plain versions at the
   ``bf16`` cell's KV hop; tokens/s, us a decode step and prefill ms a
   cell.  (J2) ``count_collectives`` around one eager 2048-token ring
   prefill equal to each cell's ``collective_count`` (its wire bytes the
   bf16 KV's), around one eager step a strategy at phase 4's heat3d layout
   equal to ``scheduled_collectives``; ``roofline(..., hw=H100)`` of the
   ring prefill beside its measured time.  Its launches join the summary
   line's under ``"J"``.
K. The last model families (``tools/families_lm.py``), after phase J, at
   full width and half depth since phase O joined (random bf16 weights
   from seed 0): (K1) zamba2-1.2b at 19 of 38 layers through
   ``ServingEngine(max_slots=4, max_len=2048)``, 8 requests of 5-2016
   prompt tokens (lengths the SSD scan takes), 16 new each:
   ``flash_attention`` once a group of 6 a prefill, tokens against the
   plain-attention engine (equal or a near tie) and the eager decode
   (equal), prefill ms, decode ms eager and graph, tokens per second, idle
   shares; (K2) its 2048-token logits in f32 on a ``(1, 8)`` ring under
   ``seq_parallel`` (``state_method`` ``ring`` and ``tree``) within
   ``families_lm.SEQ_REL_TOL`` of the local logits, which planted faults
   (ghost cells zeroed, the incoming SSD state dropped) must exceed, and
   ``seq_left_halo`` at its conv shapes with packer ``cuda`` bitwise equal
   to ``slice`` at ``n_parts`` 1 and 3, launches counted; (K3)
   llama-3.2-vision-11b at 20 of 40 layers with K1's requests and checks,
   ``flash_attention`` once a layer a prefill, and with the gates at 0.5 and a
   random image one prefill and one logits call against plain attention,
   the logits moved from the closed gates'; (K4) hubert-xlarge at 24 of 48
   layers ``encode`` of 4 x 1000 frames, ``flash_attention`` once a layer at head dim
   80, against plain attention, ms a call.  Its flash launches join the
   summary line's under ``"K"``.
L. Training (``tools/train_lm.py``), after phase G, the last: (L1) the flash
   backward kernel ``flash_attention_bwd`` against autograd through the
   plain attention in f32 at stablelm-1.6b's training shape, llama3-8b's
   GQA, hubert-xlarge's D = 80, two ragged bf16 cases (``Sq != Skv`` with
   GQA; MQA at D = 128 non-causal) and two f32 cases (ragged ``Sq !=
   Skv``; no key at all), the forward's log-sum-exp against the plain
   scores', timed at the training path's shape in turns with SDPA's
   backward (and beside the plain version's), each of its ms, SDPA's ms,
   the bound, TFLOP/s on the 5 products and three calls' bitwise equality
   (also at llama3-8b's GQA) on lines of their own; (L2) stablelm-1.6b at
   full width and depth through the port's ``Trainer``: 6 steps of 2 x
   4096 tokens in 2 microbatches, finite losses, ``flash_attention``
   launched layers x microbatches a step and
   ``flash_attention_bwd`` three times that (its pre-pass, the one pass
   and dQ's rounding, each counted), a finite non-zero gradient on every
   parameter leaf, ms a step against its floor, peak memory, the idle
   share of a traced step; (L3) a restart from a checkpoint on the card
   against an uninterrupted run (2 layers); (L4) the kernels still
   without a backward (the pack kernels, ``stencil27``, the bare
   ``flash_attention``) refuse a gradient.  Its launches join the summary
   line's under ``"L"``; the backward kernel's row is its own.
M. Every family trains (``tools/train_families_lm.py``), after phase L:
   (M1) the WKV backward kernel ``wkv_chunked_bwd`` through
   ``WkvChunkedFn`` against ``wkv_bwd_plain`` in float64 at rwkv6-1.6b's
   training shape (1, 4096, 32, 64) chunk 64, head sizes 8, 16 and 32 at
   chunk 16, ``T = c`` (64 and a ragged 40), a given ``S0`` with a
   non-zero gradient on the final state, and bf16, every output within
   its stated tolerance; three calls bitwise equal; timed by CUDA events
   and ``torch.profiler`` (a call's three ``wkv_bwd_*`` kernels summed)
   beside the plain version and autograd through ``wkv_plain``, with its
   bound and its scratch bytes; (M2) rwkv6-1.6b at full width and depth
   through the ``Trainer``, 6 steps of 2 x 4096 tokens in 2 microbatches:
   finite losses, ``wkv_chunked_bwd`` launched 48 times a step, a finite
   non-zero gradient on every leaf, ms a step against its floor, peak
   memory, the idle share and the WKV device ms of a traced step; (M3)
   hubert-xlarge at 12 of 48 layers, zamba2-1.2b at full width and
   12 of 38 layers, phi3.5-moe at 2
   layers, llama-3.2-vision-11b at one group with its gates open, 3 steps
   each: finite losses, the flash forward and backward launches, every
   leaf's gradient.  The WKV launches of M2 and the flash launches of M3
   join the summary line's under ``"M"``; the WKV backward has its row.
N. Training on a mesh of stacked ranks (``tools/train_mesh_lm.py``),
   after phase M: (N1) the ring KV hop's backward (``RingHopFn``) at
   llama3-8b's and stablelm-1.6b's ring KV shapes on 4 ranks, ``n_parts``
   1 and 4: the gradient the inverse route of the cotangent, bitwise,
   through ``gather_pack``/``copy_convert`` (their launches counted) and
   equal to the ``slice`` packer's; (N2) stablelm-1.6b at full width and
   depth through the ``Trainer`` on a ``(2, 4)`` ``("data", "model")``
   mesh with L2's data, steps 0-1, the state switched onto ``(2, 2)``
   through the host, steps 2-3: the losses against L2's one-card run, the
   state's stacked layout, ms a step, peak memory, a step's collectives
   and a traced step's idle share; then at 2 layers a checkpoint at step 2
   restored onto ``(2, 2)`` by a ``Trainer``, its steps 2-3 against the
   same state switched without a checkpoint (bitwise expected);
   (N3) gradients through ring attention (``comm_packer="cuda"``) and the
   ring-TP MLP at stablelm-1.6b's width, 2 layers, f32, against the
   local context's; (N4) phi3.5-moe at full width and 2 layers on a
   ``(2, 16)`` mesh, ``moe_mode="ep"``, 1024 tokens a data rank, 2 steps
   with its expert stacks split over the data ranks (``fsdp_experts``,
   each layer's stack pinned to one data rank) and 2 without: losses and
   the gathered state bitwise
   equal, ms a step, peak memory and collectives of each.  The flash
   launches of N2, N3's ring runs and N4 and the pack kernels' of N3 join
   the summary line's under ``"N"``.
O. The dry-run against the card (``tools/dryrun_lm.py``), after phase N,
   reading L2's record: (O1) the meta routes of ``flash_attention``,
   ``flash_attention_bwd``, ``wkv_chunked`` and ``wkv_chunked_bwd``
   through ``FlashAttentionFn``/``WkvChunkedFn`` against the kernels at
   (1, 4096, 32, 64) causal, GQA (1, 2048, 32/8, 128), D = 80 (4, 1000,
   16, 80) bf16 and WKV (1, 4096, 32, 64) f32 chunk 64: the outputs'
   shapes and dtypes equal, no launch, the counted FLOPs equal the
   bound's; (O2) ``dryrun.run_cell("stablelm-1.6b", "train_4k", False)``
   on the ``(16, 16)`` meta mesh, its record, H100 roofline terms and
   seconds; (O3) the dry-run of L2's configuration: its argument bytes
   (in the allocator's 512-byte blocks) equal to L2's placed state and
   batch, its peak within 25 % of L2's ``max_memory_allocated``, its
   roofline step beside L2's ms.  Its comparison launches are not counted.
5. Print the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.  The full record also goes to
   ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: H100 SXM data-sheet HBM3 rate, the bytes bound of every kernel here
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM data-sheet dense bf16 tensor-core rate, the operations bound
BF16_FLOP_PER_S = 989e12
#: H100 SXM data-sheet f32 rate outside the tensor cores (the WKV kernel's
#: arithmetic, f32 on the CUDA cores)
F32_FLOP_PER_S = 67e12
MESH = ((4, 2), ("pz", "py"))
GLOBAL_INTERIOR = (1024, 1024, 512)
#: stated tolerances.  Pack/unpack are elementwise converts: exact.  The
#: stencil rounds each product and sum like its plain version (no FMA), but
#: the check allows FMA-level differences: f32 rtol=1e-5, atol=1e-5; bf16
#: output one bf16 ulp (rtol=2^-7).
STENCIL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-6)}
HEAT_CYCLES, HEAT_REPEATS, VERIFY_CYCLES = 20, 3, 3
#: flash attention against its plain version, as tests/kernels/test_flash.py:
#: bf16 output rtol=atol=2e-2, f32 rtol=atol=2e-5
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
#: the bf16 route at llama3-8b S = 2048 held tighter, where FLASH_TOL's atol
#: is about half a late causal row's values: ||got - want|| / ||want|| against
#: the plain version in f32 on the same inputs, over all rows and over the
#: late half; a skipped kv tile must read above it
FLASH_REL_TOL = 5e-3
FLASH_FAULT_KEYS = (1024, 1088)
#: the kv tile left out of hubert-xlarge's non-causal D = 80 case
FLASH_FAULT_KEYS_D80 = (512, 576)
SERVE_LENGTHS = (5, 12, 100, 200, 500, 900, 1500, 2000)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 2048, 16
#: WKV against its plain version, as tests/kernels/test_wkv.py: f32
#: rtol=atol=3e-4, bf16 rtol=atol=5e-2
WKV_TOL = {"float32": 3e-4, "bfloat16": 5e-2}
#: rwkv6-1.6b serving: lengths the reference's scan accepts (at most 64, or
#: a multiple of 64); the state does not grow with max_len, and 4096 keeps
#: the 2048-token prompt clear of the max_len - 1 stop
RWKV_LENGTHS = (5, 12, 64, 128, 512, 1024, 1536, 2048)
RWKV_SLOTS, RWKV_MAX_LEN, RWKV_NEW = 4, 4096, 16
#: a near tie of two tokens in the plain run's bf16 logits, as phase B
TIE_TOL = 2e-2
#: a near tie in f32 logits: the f32 model tests' tolerance
TIE_TOL_F32 = 1e-4
#: phase E's card grid (the heat3d layout is its largest cell at 8 ranks)
SWEEP_SIZES = ((64, 64, 64), (256, 256, 256), GLOBAL_INTERIOR)
SWEEP_COUNTS = (4, 8)
#: timed cycles a repeat in the card grid: 50 x 3 gives each cell 25-250 ms
#: of timed cycles (20 x 2 gave 3-60 ms, where the cells' run-to-run spread
#: was about half their time; 200 x 3 until phase N joined, when the card
#: grid took 38.3 s of the script's 925.4)
SWEEP_CYCLES, SWEEP_REPEATS = 50, 3
AUTO_CYCLES = 3
#: decode steps a timing window (phases B and D, eager and graph in turns)
DECODE_STEPS = 20
#: phase F: processes of the grid on the one card, its heat3d cells' timed
#: cycles, the reference check's size, and the p2 sweep slab (phase E's
#: 8-rank slab) with its cycles (cut from phase E's 200 x 3, from 50 x 3
#: to 30 x 3 when phase J joined, to 10 x 3 when phase K joined and to 5 x 3
#: when phase N joined, to keep the script near half its time limit: a grid
#: cycle crosses gloo on the host; the heat3d cells' 50 x 3 became 20 x 3
#: then too)
GRID_PROCESSES = 2
GRID_CYCLES, GRID_REPEATS = 20, 3
GRID_REF_SIZE = (64, 64, 64)
P2_PARTS = (1, 4)
P2_CYCLES, P2_REPEATS = 5, 3
GRID_TIMEOUT = 600.0
#: phase G: the elastic runner's steps, the failing step and checkpoint
#: interval of each leg, and the bound of G4's grid (G1, G2: 8 ranks lose
#: half mid-exchange at step 5 and resume from step 4; G3: 4 ranks grow to
#: 8 at step 3; G4: process 1 of 2 fails at step 4, step 3's commit stays)
ELASTIC_STEPS = 8
ELASTIC_FAIL, ELASTIC_EVERY = 5, 4
JOIN_STEP = 3
GRID_FAIL, GRID_EVERY = 4, 3
ELASTIC_TIMEOUT = 600.0


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


def time_ms_batched(torch, fn, *, n: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the device time of ``n`` back-to-back
    launches of ``fn`` between one pair of CUDA events, divided by ``n``, so
    a wrapper's host time overlaps the launches before it."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def device_ms(torch, fn, *, flush, reps: int = 7) -> float:
    """Mean device time of the kernels ``fn`` launches, by ``torch.profiler``
    (the wrapper's host time left out), each call after ``flush`` (a fill,
    left out)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "Fill" not in e.key)
    return total / reps / 1e3


def attention_keys_dropped(torch, q, k, v, keys: tuple[int, int], causal: bool = True):
    """Attention (causal or not) of f32 ``(B, S, H, D)`` q and ``(B, S, Hkv,
    D)`` k, v with the keys in ``range(*keys)`` left out of every row: what a
    kernel that skipped that kv tile would return (a planted fault, plain
    PyTorch)."""
    group = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh, vh = (t.repeat_interleave(group, 2).transpose(1, 2) for t in (k, v))
    scores = (qh @ kh.mT) / math.sqrt(q.shape[-1])
    pos_q = torch.arange(q.shape[1], device=q.device)[:, None]
    pos_k = torch.arange(k.shape[1], device=q.device)[None, :]
    keep = ((pos_q >= pos_k) | (not causal)) & ((pos_k < keys[0]) | (pos_k >= keys[1]))
    return (torch.softmax(scores.masked_fill(~keep, -math.inf), -1) @ vh).transpose(1, 2)


def host_ms(torch, fn, *, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def plain_logits_at(torch, model, params, prompt, prefix, max_len):
    """The logits that follow ``prompt + prefix`` in ``model``: a bucketed
    prefill of the prompt, then one decode step per prefix token (batch 1)."""
    from repro_torch.serving.engine import _next_pow2

    dev = model.device
    bucket = min(_next_pow2(len(prompt)), max_len)
    toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    toks[0, :len(prompt)] = torch.as_tensor(prompt, device=dev)
    true_len = torch.full((1,), len(prompt), dtype=torch.int32, device=dev)
    logits, cache = model.prefill(params, {"tokens": toks}, model.init_cache(1, max_len),
                                  true_len=true_len)
    for t in prefix:
        logits, cache = model.decode_step(params, torch.tensor([[t]], device=dev), cache)
    return logits[0, -1].float()


def serve_llama(torch, dev, kernels: dict) -> dict:
    """Phase B: llama3-8b through the serving engine, flash kernel on the
    path, held against the same engine with the plain attention."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.profiling import device_breakdown
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine
    import ring_lm
    from time_plan_graph import decode_row, eager_decode_engine

    cfg = get_config("llama3-8b")
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [params["embed"], params["lm_head"], *params["norm_f"].values()]
    leaves += [t for lp in params["layers"] for g in lp.values() for t in g.values()]
    param_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    print(f"llama3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, {param_gb:.3f} GB of "
          f"{params['embed'].dtype} parameters made on the card in {init_s:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_LENGTHS]
    # warm-up outside the counted run (cuBLAS handles, the kernel library)
    model.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long, device=dev)},
                  model.init_cache(1, 8))
    torch.cuda.synchronize()

    def serve(m, engine_cls=ServingEngine):
        engine = engine_cls(m, params, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
        uids = [engine.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
        t0 = time.perf_counter()
        out = engine.run()
        torch.cuda.synchronize()
        return engine, [out[u] for u in uids], time.perf_counter() - t0

    _build.reset_launches()
    engine, tokens, serve_s = serve(model)
    launches = dict(_build.LAUNCHES)
    st = engine.stats
    buckets = sorted({engine._prefill_bucket(len(p)) for p in prompts})
    n_tokens = sum(len(t) for t in tokens)
    print(f"serve llama3-8b: {st.prefills} prefills (buckets {buckets}), {st.decode_steps} decode "
          f"steps, {n_tokens} tokens in {serve_s:.3f} s = {n_tokens / serve_s:.1f} tok/s; plans "
          f"{st.plan_inits} inits / {st.plan_hits} hits; launches {json.dumps(launches)}",
          flush=True)
    if st.prefills != len(prompts) or any(len(t) != SERVE_NEW for t in tokens):
        fail(f"served {st.prefills} prefills, token counts {[len(t) for t in tokens]}")
    if launches.get("flash_attention", 0) != cfg.n_layers * st.prefills:
        fail(f"flash_attention launched {launches.get('flash_attention', 0)} times for "
             f"{st.prefills} prefills of {cfg.n_layers} layers")
    if st.plan_inits != len(buckets) + 1:
        fail(f"{st.plan_inits} plan inits for {len(buckets)} prefill buckets + 1 decode plan")
    captured = [p.name for p in engine.plans._plans.values() if p.captured]
    if captured != ["decode_fn"]:
        fail(f"captured plans {captured}: the decode plan alone replays a CUDA graph")
    add_launches(kernels["flash_attention"], "llama3-8b serving (B)", launches["flash_attention"])

    # the same requests with the decode step eager: equal tokens
    _, eager_tokens, eager_s = serve(model, eager_decode_engine())
    if eager_tokens != tokens:
        fail(f"graph decode tokens differ from eager ones: {tokens} vs {eager_tokens}")
    print(f"tokens of the graph decode ({serve_s:.3f} s) equal the eager decode's "
          f"({eager_s:.3f} s) for all {len(prompts)} requests", flush=True)
    _build.LAUNCHES.clear()
    _build.LAUNCHES.update(launches)

    plain_model = build_model(cfg, dev, attention=attention_plain)
    _, plain_tokens, plain_s = serve(plain_model)
    if _build.LAUNCHES["flash_attention"] != launches["flash_attention"]:
        fail("the plain-attention run launched the flash kernel")
    equal, ties = 0, []
    for prompt, got, want in zip(prompts, tokens, plain_tokens):
        if got == want:
            equal += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        logits = plain_logits_at(torch, plain_model, params, prompt, got[:i], SERVE_MAX_LEN)
        la, lb = logits[got[i]].item(), logits[want[i]].item()
        gap, tol = abs(la - lb), FLASH_TOL["bfloat16"] * (1 + max(abs(la), abs(lb)))
        ties.append(dict(prompt_len=len(prompt), step=i, kernel_token=got[i], plain_token=want[i],
                         logit_gap=gap, tol=tol))
        if gap > tol:
            fail(f"prompt of {len(prompt)}: tokens differ at step {i} ({got[i]} vs {want[i]}) "
                 f"and the plain logits are {gap} apart (tol {tol}): not a near tie")
    print(f"tokens against the plain-attention engine ({plain_s:.3f} s): {equal}/{len(prompts)} "
          f"requests equal; near ties at the first difference: {json.dumps(ties)}", flush=True)

    prefill_ms, prefill_logit_err = {}, {}
    for bucket in buckets:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, bucket)), device=dev)
        cache1 = model.init_cache(1, SERVE_MAX_LEN)
        true_len = torch.full((1,), max(1, bucket - 3), dtype=torch.int32, device=dev)
        prefill_ms[bucket] = host_ms(torch, lambda: model.prefill(
            params, {"tokens": toks}, cache1, true_len=true_len))
        # the same prefill with the plain attention: how far 32 layers carry
        # the kernel's bf16 rounding differences into the logits
        got = model.prefill(params, {"tokens": toks}, cache1, true_len=true_len)[0].float()
        want = plain_model.prefill(params, {"tokens": toks}, cache1, true_len=true_len)[0].float()
        if not torch.isfinite(got).all():
            fail(f"prefill at bucket {bucket}: non-finite logits")
        prefill_logit_err[bucket] = (got - want).abs().max().item()
    print(f"prefill ms by bucket {json.dumps(prefill_ms)}; max |logit kernel - plain| "
          f"{json.dumps(prefill_logit_err)}", flush=True)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, SERVE_MAX_LEN)), device=dev)
    prefill_trace = device_breakdown(lambda: model.prefill(
        params, {"tokens": toks}, cache1, true_len=true_len), n_cycles=1)
    # the decode plan eager (plan.fn) and replayed (plan.start), in turns
    decode_timing = decode_row(torch, engine, n=DECODE_STEPS, rounds=2)
    decode_ms = decode_timing["eager"]["us"] / 1e3
    decode_trace = decode_timing["eager"].pop("breakdown")
    graph_trace = decode_timing["graph"].pop("breakdown")
    # host cost of one eager op on the card (a small in-place add)
    scratch = torch.zeros(1024, device=dev)
    op_us = host_ms(torch, lambda: [scratch.add_(1.0) for _ in range(500)]) / 500 * 1e3
    decode_launches = sum(k["launches_per_cycle"] for k in decode_trace["kernels"])
    print(f"decode step: eager {decode_ms:.2f} ms (idle {decode_trace['idle_share']:.3f}, by host "
          f"clock {decode_timing['eager']['idle_share_host']:.3f}), graph "
          f"{decode_timing['graph']['us'] / 1e3:.2f} ms (idle {graph_trace['idle_share']:.3f}, by "
          f"host clock {decode_timing['graph']['idle_share_host']:.3f}), "
          f"{decode_launches:g} device activities per eager step; decode plan init with the "
          f"capture {decode_timing['init_us'] / 1e3:.1f} ms; one eager op costs {op_us:.1f} us "
          f"of host time", flush=True)
    for label, b in (("prefill 2048", prefill_trace), ("decode step eager", decode_trace),
                     ("decode step graph", graph_trace)):
        top = ", ".join(f"{short_kernel_name(k['name'])} x{k['launches_per_cycle']:g} "
                        f"{k['us_per_cycle']:.0f}us" for k in b["kernels"][:5])
        print(f"{label} breakdown: window {b['window_us_per_cycle']:.0f} us, device busy "
              f"{b['busy_us_per_cycle']:.0f} us, idle share {b['idle_share']:.3f}; {top}",
              flush=True)
    out = dict(
        model="llama3-8b", layers=cfg.n_layers, param_gb=param_gb, init_s=init_s,
        slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prompt_lengths=list(SERVE_LENGTHS),
        buckets=buckets, prefills=st.prefills, decode_steps=st.decode_steps,
        plan_inits=st.plan_inits, plan_hits=st.plan_hits, launches=launches,
        tokens=n_tokens, serve_s=serve_s, tokens_per_s=n_tokens / serve_s,
        plain_serve_s=plain_s, equal_requests=equal, near_ties=ties, eager_decode_serve_s=eager_s,
        prefill_ms=prefill_ms, prefill_logit_err=prefill_logit_err, decode_ms=decode_ms,
        decode_graph_ms=decode_timing["graph"]["us"] / 1e3, decode_timing=decode_timing,
        decode_device_activities=decode_launches, host_us_per_op=op_us,
        prefill_idle_share=prefill_trace["idle_share"], decode_idle_share=decode_trace["idle_share"],
        decode_graph_idle_share=graph_trace["idle_share"],
        prefill_trace=prefill_trace, decode_trace=decode_trace, decode_graph_trace=graph_trace,
    )
    print("serving:", json.dumps({k: v for k, v in out.items() if not k.endswith("_trace")}),
          flush=True)

    # -- H1, H2: sequence-parallel llama3-8b on a virtual ring of 8 ranks ----
    t0 = time.perf_counter()
    try:
        ring = ring_lm.llama_ring(torch, dev, model, params, prompts, tokens, slots=SERVE_SLOTS,
                                  max_len=SERVE_MAX_LEN, new_tokens=SERVE_NEW,
                                  logits_at=plain_logits_at)
    except ring_lm.PhaseFailure as e:
        fail(f"phase H (llama3-8b): {e}")
    ring["phase_s"] = time.perf_counter() - t0
    for kname in ("copy_convert", "gather_pack"):
        add_launches(kernels[kname], "ring prefill, llama3-8b serving (H1)",
                     ring["launches"].get(kname, 0))
    print(f"phase H (llama3-8b) took {ring['phase_s']:.1f} s", flush=True)
    out["ring"] = ring
    return out


def serve_moe(torch, dev, kernels: dict) -> dict:
    """Phase I (``tools/moe_lm.py``): phi3.5-moe served and expert-parallel,
    one grok-1 MoE FFN; its launches join the summary line's."""
    import moe_lm
    import ring_lm

    t0 = time.perf_counter()
    try:
        out = moe_lm.moe_phase(torch, dev, hbm_bytes_per_s=HBM_BYTES_PER_S)
    except ring_lm.PhaseFailure as e:
        fail(f"phase I: {e}")
    out["phase_s"] = time.perf_counter() - t0
    add_launches(kernels["flash_attention"], "phi3.5-moe serving (I1)",
                 out["serve"]["launches"].get("flash_attention", 0))
    add_launches(kernels["flash_attention"], "phi3.5-moe expert-parallel logits (I2)",
                 out["ep"]["launches_total"].get("flash_attention", 0))
    for kname in ("copy_convert", "gather_pack"):
        add_launches(kernels[kname], "MoE expert dispatch and return (I2, I3)",
                     out["ep"]["launches_total"].get(kname, 0)
                     + out["grok"]["launches_total"].get(kname, 0))
    print(f"phase I took {out['phase_s']:.1f} s", flush=True)
    return out


def serve_bench(torch, dev, kernels: dict, out_dir: pathlib.Path) -> dict:
    """Phase J (``tools/serve_bench_lm.py``): the LM serve bench at
    stablelm-1.6b's full width through its CLI, and the collective count of
    a ring prefill and of one heat3d step a strategy (phase 4's layout and
    update); its pack launches join the summary line's under ``"J"``."""
    import ring_lm
    import serve_bench_lm

    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels.stencil27.ref import jacobi_weights
    from repro_torch.stencil import Domain
    from repro_torch.stencil.heat3d import DOMAIN_AXES, heat3d_update

    dom = Domain(make_mesh(*MESH, device=dev), GLOBAL_INTERIOR, DOMAIN_AXES)
    update = heat3d_update(jacobi_weights().numpy(), dev)
    t0 = time.perf_counter()
    try:
        out = serve_bench_lm.serve_bench_phase(torch, dev, out_dir, dom, update,
                                               logits_at=plain_logits_at)
    except ring_lm.PhaseFailure as e:
        fail(f"phase J: {e}")
    out["phase_s"] = time.perf_counter() - t0
    for kname in ("copy_convert", "gather_pack"):
        add_launches(kernels[kname], "J", out["launches"].get(kname, 0))
    print(f"phase J took {out['phase_s']:.1f} s", flush=True)
    return out


def families(torch, dev, kernels: dict) -> dict:
    """Phase K (``tools/families_lm.py``): zamba2-1.2b served and
    sequence-parallel, llama-3.2-vision-11b served, hubert-xlarge's encoder;
    its flash launches join the summary line's under ``"K"``."""
    import families_lm
    import ring_lm

    t0 = time.perf_counter()
    try:
        out = families_lm.families_phase(torch, dev, hbm_bytes_per_s=HBM_BYTES_PER_S)
    except ring_lm.PhaseFailure as e:
        fail(f"phase K: {e}")
    out["phase_s"] = time.perf_counter() - t0
    add_launches(kernels["flash_attention"], "K",
                 sum(out[t]["launches"].get("flash_attention", 0) for t in ("K1", "K3", "K4")))
    print(f"phase K took {out['phase_s']:.1f} s", flush=True)
    return out


def training(torch, dev, kernels: dict) -> dict:
    """Phase L (``tools/train_lm.py``): the flash backward against its
    plain version, stablelm-1.6b trained at full width, a restart on the
    card, rwkv's refusal; the flash launches of the Trainer's run join the
    summary line's under ``"L"``, with the backward kernel's own row."""
    import train_lm

    t0 = time.perf_counter()
    try:
        out = train_lm.train_phase(torch, dev)
    except train_lm.PhaseFailure as e:
        fail(f"phase L: {e}")
    out["phase_s"] = time.perf_counter() - t0
    launches = out["L2"]["launches"]
    add_launches(kernels["flash_attention"], "L", launches.get("flash_attention", 0))
    path = out["L1"]["path"]
    kernels["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash.py:127",
        replaces_note="the backward of flash_attention; the JAX package has no backward kernel "
                      "and differentiates its plain attention with XLA",
        max_abs_err=out["L1"]["max_abs_err"], ms=path["ms"], plain_ms=path["plain_ms"],
        bound_ms=path["bound_ms"], bound_by=path["bound_by"], library_ms=path["library_ms"],
        timing=path["timing"], shape=path["shape"], flops=path["flops"],
        flop_convention=path["flop_convention"], tflops=path["tflops"],
        bitwise_repeatable=path["bitwise_repeatable"])
    add_launches(kernels["flash_attention_bwd"], "L", launches.get("flash_attention_bwd", 0))
    if not kernels["flash_attention_bwd"]["launches"]:
        fail("phase L: the training path never launched flash_attention_bwd")
    print(f"phase L took {out['phase_s']:.1f} s", flush=True)
    return out


def families_training(torch, dev, kernels: dict) -> dict:
    """Phase M (``tools/train_families_lm.py``): the WKV backward against
    its plain version, rwkv6-1.6b trained at full width, the other families'
    steps; the WKV launches of M2 and the flash launches of M3 join the
    summary line's under ``"M"``, with the WKV backward's own row."""
    import train_families_lm
    import train_lm

    t0 = time.perf_counter()
    try:
        out = train_families_lm.families_train_phase(torch, dev)
    except train_lm.PhaseFailure as e:
        fail(f"phase M: {e}")
    out["phase_s"] = time.perf_counter() - t0
    m2 = out["M2"]["launches"]
    add_launches(kernels["wkv_chunked"], "M", m2.get("wkv_chunked", 0))
    for name in ("flash_attention", "flash_attention_bwd"):
        add_launches(kernels[name], "M", sum(f["launches"].get(name, 0)
                                             for f in out["M3"].values() if isinstance(f, dict)
                                             and "launches" in f))
    path = out["M1"]["path"]
    kernels["wkv_chunked_bwd"] = dict(
        name="wkv_chunked_bwd", route="cuda", source="src/repro_torch/kernels/csrc/wkv.cu",
        replaces="src/repro/kernels/wkv/wkv.py:90",
        replaces_note="the backward of wkv_chunked; the JAX package has no backward kernel "
                      "and differentiates its jnp wkv_scan (src/repro/models/rwkv.py) with XLA",
        max_abs_err=out["M1"]["max_abs_err"], ms=path["ms"], plain_ms=path["plain_ms"],
        bound_ms=path["bound_ms"], bound_by=path["bound_by"], library_ms=None,
        device_ms=path["device_ms"], kernels_a_call=path["device_launches_a_call"],
        device_ms_by_kernel=path["device_ms_by_kernel"],
        device_ms_source=path["device_ms_source"],
        scratch_bytes_a_call=path["scratch_bytes_a_call"],
        autograd_plain_ms=path["autograd_plain_ms"],
        timing=path["timing"], shape="r, k, v, lw, dy (1, 4096, 32, 64) f32, chunk 64",
        flops=path["flops"], flop_convention=path["flop_convention"], bytes=path["bytes"],
        bitwise_repeatable=path["bitwise_repeatable"])
    add_launches(kernels["wkv_chunked_bwd"], "M", m2.get("wkv_chunked_bwd", 0))
    if not kernels["wkv_chunked_bwd"]["launches"]:
        fail("phase M: the training path never launched wkv_chunked_bwd")
    print(f"phase M took {out['phase_s']:.1f} s", flush=True)
    return out


def mesh_training(torch, dev, kernels: dict, l2: dict) -> dict:
    """Phase N (``tools/train_mesh_lm.py``): the ring hop's backward,
    stablelm-1.6b data-parallel on a mesh of stacked ranks and restarted
    onto a smaller one, gradients through the ring paths; the flash
    launches of N2 and the launches of N3's ring runs join the summary
    line's under ``"N"``."""
    import train_lm
    import train_mesh_lm

    t0 = time.perf_counter()
    try:
        out = train_mesh_lm.mesh_phase(torch, dev, l2)
    except train_lm.PhaseFailure as e:
        fail(f"phase N: {e}")
    out["phase_s"] = time.perf_counter() - t0
    runs = [out[n]["launches"] for n in ("N2", "N3", "N4")]
    for name in ("flash_attention", "flash_attention_bwd", "gather_pack", "copy_convert"):
        add_launches(kernels[name], "N", sum(r.get(name, 0) for r in runs))
    for name in ("flash_attention_bwd", "gather_pack", "copy_convert"):
        if not kernels[name]["launches_by_path"]["N"]:
            fail(f"phase N: the mesh paths never launched {name}")
    print(f"phase N took {out['phase_s']:.1f} s", flush=True)
    return out


def examples(torch, dev, kernels: dict) -> dict:
    """Phase P (``tools/examples_lm.py``): the three examples at their
    defaults; their launches join the summary line's under ``"P"``."""
    import examples_lm

    t0 = time.perf_counter()
    try:
        out = examples_lm.examples_phase(torch, dev)
    except RuntimeError as e:
        fail(f"phase P: {e}")
    out["phase_s"] = time.perf_counter() - t0
    # flash_attention_bwd's row is made in phase L, which adds its P launches
    for path, launches in out["launches"].items():
        for name, n in launches.items():
            if name != "flash_attention_bwd":
                add_launches(kernels[name], "P", n)
    out["launches_bwd"] = sum(v.get("flash_attention_bwd", 0)
                              for v in out["launches"].values())
    print(f"phase P took {out['phase_s']:.1f} s", flush=True)
    return out


def dryrun_check(torch, dev, l2: dict) -> dict:
    """Phase O (``tools/dryrun_lm.py``): the LM kernels' meta routes against
    the kernels on the card, stablelm-1.6b's production train cell on the
    meta mesh with its H100 roofline, and the dry-run of L2's configuration
    against L2's memory.  It launches no kernel of the main paths (its
    comparison launches are not counted)."""
    import dryrun_lm
    import train_lm

    t0 = time.perf_counter()
    try:
        out = dryrun_lm.dryrun_phase(torch, dev, l2)
    except train_lm.PhaseFailure as e:
        fail(f"phase O: {e}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase O took {out['phase_s']:.1f} s", flush=True)
    return out


def add_launches(kd: dict, path: str, n: int) -> None:
    """Count ``n`` launches of a kernel on one more main path of the
    summary line: ``launches`` is the sum over ``launches_by_path``."""
    by = kd.setdefault("launches_by_path", {})
    by[path] = by.get(path, 0) + n
    kd["launches"] = sum(by.values())


def wkv_flops_factored(rows: int, T: int, c: int, hd: int) -> int:
    """Operations of the factored form the kernel computes, counted as
    ``costs.wkv_flops`` but for the pairwise term: in the diagonal 16-row
    sub-blocks a subtract, an exponential, two multiplies and an add per
    (t, s, channel), and between sub-blocks one multiply and one add (the
    three factors are taken once a row or a sub-block, and, as in
    ``costs.wkv_flops``, the decays of r and k are not counted).  Information
    beside the bound, whose convention stays ``costs.wkv_flops``."""
    sizes = [min(16, c - 16 * p) for p in range(-(-c // 16))]
    diag = sum(n * (n - 1) // 2 for n in sizes)
    off = c * (c - 1) // 2 - diag
    per_chunk = (4 * c * hd * hd + 5 * hd * diag + 2 * hd * off
                 + c * (c + 1) * hd + 3 * c * hd)
    return rows * (T // c) * per_chunk


def wkv_exps(c: int, hd: int) -> dict:
    """Exponentials a head takes per chunk of c rows (information beside the
    bound, whose convention is unchanged): ``per_tile_pairwise``, the
    pairwise form c(c-1)/2*hd and the decays of r and k in each of the
    hd/16 column tiles (as the first port took them); and ``factored``,
    the factored kernel, which takes the pair form only in the diagonal
    16-row sub-blocks, once a pair of CTAs (a CTA alone where hd <= 16),
    and whose every CTA takes the decays of its prep (r, k, and the factors
    between sub-blocks)."""
    tiles = max(1, hd // 16)
    cluster = min(2, tiles)
    nsb = -(-c // 16)
    prep = 2 * nsb * 16 * hd + 2 * nsb * hd + nsb * (nsb - 1) // 2 * hd + hd
    return dict(per_tile_pairwise=tiles * (c * (c - 1) // 2 * hd + 2 * c * hd + hd),
                factored=tiles // cluster * nsb * 120 * hd + tiles * prep,
                pairwise_once=c * (c - 1) // 2 * hd)


def check_wkv(torch, dev, kernels: dict) -> dict:
    """Phase C: the WKV kernel against its plain version at the rwkv6-1.6b
    serving path's shapes, timed at prefill T = 2048 and decode batch 4."""
    from time_copy_convert import host_us

    from repro_torch.kernels.costs import wkv_cost
    from repro_torch.kernels.wkv import wkv_chunked, wkv_plain

    gen = torch.Generator(dev).manual_seed(11)
    H, hd, chunk = 32, 64, 64

    def inputs(B, T, dtype=torch.float32, state=False, lw_value=None):
        r, k, v = (torch.randn((B, T, H, hd), generator=gen, device=dev) for _ in range(3))
        # the model's decays: -exp(w_base + lora) with w_base ~ N(-1, 0.5)
        lw = (torch.full_like(r, lw_value) if lw_value is not None else
              -torch.exp(torch.randn((B, T, H, hd), generator=gen, device=dev) * 0.5 - 1.0))
        u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
        S0 = torch.randn((B, H, hd, hd), generator=gen, device=dev) if state else None
        return [t.to(dtype) for t in (r, k, v, lw, u)], S0

    cases = [(f"prefill f32 B=1 T={T}", dict(B=1, T=T)) for T in (5, 17, 37, 64, 128, 2048)]
    cases += [("decode f32 B=4 T=1, given state", dict(B=4, T=1, state=True)),
              ("prefill bf16 B=1 T=128", dict(B=1, T=128, dtype=torch.bfloat16)),
              ("strong decay f32 B=1 T=128 (lw=-12)", dict(B=1, T=128, lw_value=-12.0)),
              ("prefill f32 B=2 T=256, given state", dict(B=2, T=256, state=True))]
    # the model's decay clamp ends (models/rwkv.py: -exp(clamp(., -8, 4))),
    # held against the plain version in float64: at -exp(4) a 64-row sum of
    # log decays reaches -3494, where float32's cum - lw (the plain
    # version's cum_prev) is off from the previous row's sum by ulps of
    # 2.4e-4; the kernel sums inside 16-row sub-blocks
    for name, value in (("clamp end -exp(4)", -math.exp(4.0)), ("clamp end -exp(-8)", -math.exp(-8.0))):
        cases += [(f"{name} f32 B=1 T=128", dict(B=1, T=128, lw_value=value, f64=True)),
                  (f"{name} f32 decode B=4, given state", dict(B=4, T=1, state=True,
                                                               lw_value=value, f64=True))]
    worst, errs = 0.0, {}
    for label, kw in cases:
        plain = torch.float64 if kw.pop("f64", False) else torch.float32
        (r, k, v, lw, u), S0 = inputs(**kw)
        y, S = wkv_chunked(r, k, v, lw, u, chunk=chunk, S0=S0)
        want_y, want_S = wkv_plain(*(t.to(plain) for t in (r, k, v, lw, u)), chunk=chunk,
                                   S0=None if S0 is None else S0.to(plain))
        torch.cuda.synchronize()
        dname = str(r.dtype)[6:]
        tol = WKV_TOL[dname]
        want_y, want_S = want_y.float().to(r.dtype), want_S.float()
        err_y = (y.float() - want_y.float()).abs().max().item()
        err_S = (S - want_S).abs().max().item()
        if not (torch.isfinite(y.float()).all() and torch.isfinite(S).all()):
            fail(f"wkv_chunked {label}: non-finite output or state")
        if not (torch.allclose(y.float(), want_y.float(), rtol=tol, atol=tol)
                and torch.allclose(S, want_S, rtol=tol, atol=tol)):
            fail(f"wkv_chunked {label}: max abs err y {err_y}, state {err_S} (tol {tol})")
        worst = max(worst, err_y, err_S)
        errs[label] = dict(y=err_y, state=err_S, tol=tol, plain=str(plain)[6:])
        if plain == torch.float64:  # the float32 plain version's own distance, information
            p32_y, p32_S = wkv_plain(r, k, v, lw, u, chunk=chunk, S0=S0)
            errs[label]["plain_f32_vs_f64"] = max((p32_y.float() - want_y.float()).abs().max().item(),
                                                  (p32_S - want_S).abs().max().item())
        print(f"wkv_chunked {label} {tuple(r.shape)} {dname}: max abs err y {err_y}, "
              f"state {err_S} (tol {tol}, plain in {str(plain)[6:]})", flush=True)
    none = lambda: None  # noqa: E731  (no flush: the path's inputs come warm from its GEMMs)
    (r, k, v, lw, u), _ = inputs(1, 2048)
    run = lambda: wkv_chunked(r, k, v, lw, u, chunk=chunk)  # noqa: E731
    prefill = dict(
        ms=time_ms(torch, run), ms_batched=time_ms_batched(torch, run),
        device_ms=device_ms(torch, run, flush=none), host_us=host_us(torch, run, calls=50),
        plain_ms=time_ms(torch, lambda: wkv_plain(r, k, v, lw, u, chunk=chunk), reps=3),
        flops=wkv_cost(1, 2048, H, hd, chunk, itemsize=4, u_numel=u.numel())[0],
        flops_factored=wkv_flops_factored(H, 2048, chunk, hd),
        bytes=wkv_cost(1, 2048, H, hd, chunk, itemsize=4, u_numel=u.numel())[1],
        exps_per_head_chunk=wkv_exps(chunk, hd))
    (dr, dk, dv, dlw, du), dS0 = inputs(4, 1, state=True)
    drun = lambda: wkv_chunked(dr, dk, dv, dlw, du, chunk=chunk, S0=dS0)  # noqa: E731
    decode = dict(
        ms=time_ms(torch, drun), ms_batched=time_ms_batched(torch, drun),
        device_ms=device_ms(torch, drun, flush=none), host_us=host_us(torch, drun),
        plain_ms=time_ms(torch, lambda: wkv_plain(dr, dk, dv, dlw, du, chunk=chunk, S0=dS0)),
        flops=wkv_cost(4, 1, H, hd, 1, itemsize=4, u_numel=du.numel(), S0=True)[0],
        flops_factored=wkv_flops_factored(4 * H, 1, 1, hd),
        bytes=wkv_cost(4, 1, H, hd, 1, itemsize=4, u_numel=du.numel(), S0=True)[1])
    for d in (prefill, decode):
        t_ops, t_bytes = d["flops"] / F32_FLOP_PER_S * 1e3, d["bytes"] / HBM_BYTES_PER_S * 1e3
        d.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes")
        # the same bound from the factored form's count, and the distance to each
        d["bound_factored_ms"] = max(d["flops_factored"] / F32_FLOP_PER_S * 1e3, t_bytes)
        d["device_over_bound"] = d["device_ms"] / d["bound_ms"]
        d["device_over_bound_factored"] = d["device_ms"] / d["bound_factored_ms"]
    for label, d in (("prefill", prefill), ("decode", decode)):
        print(f"wkv_chunked {label}: device {d['device_ms']} ms, bound {d['bound_ms']} ms "
              f"({d['device_over_bound']:.2f}x), factored-form bound {d['bound_factored_ms']} ms "
              f"({d['device_over_bound_factored']:.2f}x)", flush=True)
    kernels["wkv_chunked"] = dict(
        name="wkv_chunked", route="cuda", source="src/repro_torch/kernels/csrc/wkv.cu",
        replaces="src/repro/kernels/wkv/wkv.py:90", max_abs_err=worst,
        ms=prefill["ms"], plain_ms=prefill["plain_ms"], bound_ms=prefill["bound_ms"],
        bound_by=prefill["bound_by"], library_ms=None,
        shape="r, k, v, lw (1, 2048, 32, 64) f32, chunk 64", flops=prefill["flops"],
        flop_convention="per (row, chunk): 4*c*hd^2 + 5*hd*c(c-1)/2 + c(c+1)*hd + 3*c*hd",
        bytes=prefill["bytes"], prefill=prefill,
        decode=dict(decode, shape="(4, 1, 32, 64) f32 + state"), errors=errs,
    )
    print("wkv_chunked:", json.dumps(kernels["wkv_chunked"]), flush=True)
    return kernels["wkv_chunked"]


def rwkv_logits_at(torch, model, params, prompt, prefix, max_len):
    """The logits that follow ``prompt + prefix`` in ``model``: an
    exact-length prefill of the prompt, then one decode step per prefix
    token (batch 1)."""
    dev = model.device
    toks = torch.as_tensor([prompt], dtype=torch.long, device=dev)
    logits, cache = model.prefill(params, {"tokens": toks}, model.init_cache(1, max_len))
    for t in prefix:
        logits, cache = model.decode_step(params, torch.tensor([[t]], device=dev), cache)
    return logits[0, -1].float()


def to_f32_tree(tree):
    if isinstance(tree, dict):
        return {k: to_f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32_tree(v) for v in tree]
    return tree.float()


def compare_rwkv_tokens(torch, plain_model, params, prompts, got_tokens, want_tokens, tie_tol,
                        *, check: bool):
    """Requests whose tokens equal the plain engine's, and at the first
    difference of each other request the gap of the two tokens' logits in
    the plain model.  With ``check``, a differing prefill token, or a gap
    above ``tie_tol * (1 + |logit|)``, fails the run."""
    equal, ties = 0, []
    for prompt, got, want in zip(prompts, got_tokens, want_tokens):
        if got == want:
            equal += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        logits = rwkv_logits_at(torch, plain_model, params, prompt, got[:i], RWKV_MAX_LEN)
        la, lb = logits[got[i]].item(), logits[want[i]].item()
        gap, tol = abs(la - lb), tie_tol * (1 + max(abs(la), abs(lb)))
        ties.append(dict(prompt_len=len(prompt), step=i, kernel_token=got[i], plain_token=want[i],
                         logit_gap=gap, tol=tol))
        if check and i == 0:
            fail(f"prompt of {len(prompt)}: the prefill token differs ({got[0]} vs {want[0]})")
        if check and gap > tol:
            fail(f"prompt of {len(prompt)}: tokens differ at step {i} ({got[i]} vs {want[i]}) "
                 f"and the plain logits are {gap} apart (tol {tol}): not a near tie")
    return equal, ties


def serve_rwkv(torch, dev, kernels: dict) -> dict:
    """Phase D: rwkv6-1.6b through the serving engine, the WKV kernel on
    the path; the kernel held against the plain WKV on the path's own
    inputs, and the tokens against an engine with the plain WKV (held with
    the weights in f32, reported in bf16)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.profiling import device_breakdown
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv_chunked, wkv_plain
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine
    import ring_lm
    from time_plan_graph import decode_row, eager_decode_engine

    cfg = get_config("rwkv6-1.6b")
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def leaves(tree):
        return ([t for v in tree.values() for t in leaves(v)] if isinstance(tree, dict)
                else [t for v in tree for t in leaves(v)] if isinstance(tree, list) else [tree])

    n_params = sum(t.numel() for t in leaves(params))
    param_gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    print(f"rwkv6-1.6b: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} parameters, "
          f"{param_gb:.3f} GB of {params['embed'].dtype} made on the card in {init_s:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in RWKV_LENGTHS]
    # warm-up outside the counted run (cuBLAS handles, the kernel library)
    model.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long, device=dev)},
                  model.init_cache(1, 8))
    torch.cuda.synchronize()

    def serve(m, weights=params, engine_cls=ServingEngine):
        engine = engine_cls(m, weights, max_slots=RWKV_SLOTS, max_len=RWKV_MAX_LEN)
        uids = [engine.submit(p, max_new_tokens=RWKV_NEW) for p in prompts]
        t0 = time.perf_counter()
        out = engine.run()
        torch.cuda.synchronize()
        return engine, [out[u] for u in uids], time.perf_counter() - t0

    _build.reset_launches()
    engine, tokens, serve_s = serve(model)
    launches = dict(_build.LAUNCHES)
    st = engine.stats
    n_tokens = sum(len(t) for t in tokens)
    print(f"serve rwkv6-1.6b: {st.prefills} prefills (lengths {list(RWKV_LENGTHS)}), "
          f"{st.decode_steps} decode steps, {n_tokens} tokens in {serve_s:.3f} s = "
          f"{n_tokens / serve_s:.1f} tok/s; plans {st.plan_inits} inits / {st.plan_hits} hits; "
          f"launches {json.dumps(launches)}", flush=True)
    if st.prefills != len(prompts) or any(len(t) != RWKV_NEW for t in tokens):
        fail(f"served {st.prefills} prefills, token counts {[len(t) for t in tokens]}")
    # a layer's scan per prefill and per decode step (replays included),
    # and per layer once more: the decode plan's eager warm-up at init
    want_launches = cfg.n_layers * (st.prefills + st.decode_steps + 1)
    if launches.get("wkv_chunked", 0) != want_launches:
        fail(f"wkv_chunked launched {launches.get('wkv_chunked', 0)} times for {st.prefills} "
             f"prefills, {st.decode_steps} decode steps and the decode plan's warm-up of "
             f"{cfg.n_layers} layers (want {want_launches})")
    if st.plan_inits != len(set(RWKV_LENGTHS)) + 1:
        fail(f"{st.plan_inits} plan inits for {len(set(RWKV_LENGTHS))} prompt lengths + 1 decode plan")
    captured = [p.name for p in engine.plans._plans.values() if p.captured]
    if captured != ["decode_fn"]:
        fail(f"captured plans {captured}: the decode plan alone replays a CUDA graph")
    add_launches(kernels["wkv_chunked"], "rwkv6-1.6b serving (D)", launches["wkv_chunked"])

    # the same requests with the decode step eager: equal tokens
    _build.reset_launches()
    _, eager_tokens, eager_s = serve(model, engine_cls=eager_decode_engine())
    eager_launches = _build.LAUNCHES["wkv_chunked"]
    if eager_tokens != tokens:
        fail(f"graph decode tokens differ from eager ones: {tokens} vs {eager_tokens}")
    if eager_launches != cfg.n_layers * (st.prefills + st.decode_steps):
        fail(f"the eager-decode run launched wkv_chunked {eager_launches} times")
    print(f"tokens of the graph decode ({serve_s:.3f} s) equal the eager decode's "
          f"({eager_s:.3f} s) for all {len(prompts)} requests", flush=True)
    _build.LAUNCHES.clear()
    _build.LAUNCHES.update(launches)

    plain_model = build_model(cfg, dev, wkv=wkv_plain)
    _, plain_tokens, plain_s = serve(plain_model)
    if _build.LAUNCHES["wkv_chunked"] != launches["wkv_chunked"]:
        fail("the plain-WKV run launched the WKV kernel")

    # the kernel against its plain version on the path's own inputs: every
    # layer's scan of each prompt's prefill and of one batch-4 decode step
    path_err = {"y": 0.0, "state": 0.0, "calls": 0}

    def both(r, k, v, lw, u, *, chunk, S0=None):
        y, S = wkv_chunked(r, k, v, lw, u, chunk=chunk, S0=S0)
        want_y, want_S = wkv_plain(r, k, v, lw, u, chunk=chunk, S0=S0)
        tol = WKV_TOL["float32"]
        if not (torch.allclose(y, want_y, rtol=tol, atol=tol)
                and torch.allclose(S, want_S, rtol=tol, atol=tol)):
            fail(f"wkv_chunked on the path's inputs {tuple(r.shape)}: max abs err y "
                 f"{(y - want_y).abs().max().item()}, state {(S - want_S).abs().max().item()}")
        path_err["y"] = max(path_err["y"], (y - want_y).abs().max().item())
        path_err["state"] = max(path_err["state"], (S - want_S).abs().max().item())
        path_err["calls"] += 1
        return y, S

    check_model = build_model(cfg, dev, wkv=both)
    prefill_gap = []
    for prompt, got, want in zip(prompts, tokens, plain_tokens):
        toks = torch.as_tensor([prompt], dtype=torch.long, device=dev)
        lk = check_model.prefill(params, {"tokens": toks}, model.init_cache(1, 8))[0][0, -1].float()
        lp = plain_model.prefill(params, {"tokens": toks}, model.init_cache(1, 8))[0][0, -1].float()
        if not torch.isfinite(lk).all():
            fail(f"prefill of {len(prompt)}: non-finite logits")
        top2 = torch.topk(lp, 2)
        prefill_gap.append(dict(prompt_len=len(prompt), kernel_token=got[0], plain_token=want[0],
                                plain_top2_gap=(top2.values[0] - top2.values[1]).item(),
                                max_logit_diff=(lk - lp).abs().max().item(),
                                max_abs_logit=lp.abs().max().item()))
    check_model.decode_step(params, torch.zeros((RWKV_SLOTS, 1), dtype=torch.long, device=dev),
                            engine._cache)
    print(f"wkv_chunked on the path's own inputs ({path_err['calls']} scans: 8 prefills and a "
          f"decode step, 24 layers each) against wkv_plain: max abs err y {path_err['y']}, "
          f"state {path_err['state']} (tol {WKV_TOL['float32']})", flush=True)
    print(f"prefill logits, kernel engine vs plain: {json.dumps(prefill_gap)}", flush=True)
    equal, ties = compare_rwkv_tokens(torch, plain_model, params, prompts, tokens,
                                      plain_tokens, TIE_TOL, check=False)
    print(f"bf16 tokens against the plain-WKV engine ({plain_s:.3f} s), reported, not held: "
          f"{equal}/{len(prompts)} requests equal; first differences: {json.dumps(ties)}",
          flush=True)

    # the token check: the same weights in f32, where the scan's f32-level
    # differences stay far below the logits' gaps; kernel engine against
    # plain engine, the prefill token must agree
    cfg32 = cfg.with_updates(dtype="float32", param_dtype="float32")
    params32 = to_f32_tree(params)
    model32, plain32 = build_model(cfg32, dev), build_model(cfg32, dev, wkv=wkv_plain)
    engine32, tokens32, serve32_s = serve(model32, params32)
    _, plain_tokens32, plain32_s = serve(plain32, params32)
    equal32, ties32 = compare_rwkv_tokens(torch, plain32, params32, prompts, tokens32,
                                          plain_tokens32, TIE_TOL_F32, check=True)
    logit_err32 = {}
    for prompt in prompts:
        toks = torch.as_tensor([prompt], dtype=torch.long, device=dev)
        lk = model32.prefill(params32, {"tokens": toks}, model32.init_cache(1, 8))[0]
        lp = plain32.prefill(params32, {"tokens": toks}, model32.init_cache(1, 8))[0]
        logit_err32[len(prompt)] = (lk - lp).abs().max().item()
    print(f"f32 tokens, WKV kernel ({serve32_s:.3f} s) against the plain WKV ({plain32_s:.3f} s): "
          f"{equal32}/{len(prompts)} requests equal; near ties at the first difference: "
          f"{json.dumps(ties32)}; max |prefill logit kernel - plain| {json.dumps(logit_err32)}",
          flush=True)
    del engine32

    prefill_ms = {}
    for n in RWKV_LENGTHS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, n)), device=dev)
        cache1 = model.init_cache(1, RWKV_MAX_LEN)
        prefill_ms[n] = host_ms(torch, lambda: model.prefill(params, {"tokens": toks}, cache1))
    print(f"prefill ms by length {json.dumps(prefill_ms)}", flush=True)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 2048)), device=dev)
    cache1 = model.init_cache(1, RWKV_MAX_LEN)
    prefill_trace = device_breakdown(lambda: model.prefill(params, {"tokens": toks}, cache1),
                                     n_cycles=1)
    # the decode plan eager (plan.fn) and replayed (plan.start), in turns
    decode_timing = decode_row(torch, engine, n=DECODE_STEPS, rounds=2)
    decode_ms = decode_timing["eager"]["us"] / 1e3
    decode_trace = decode_timing["eager"].pop("breakdown")
    graph_trace = decode_timing["graph"].pop("breakdown")
    decode_launches = sum(k["launches_per_cycle"] for k in decode_trace["kernels"])
    print(f"decode step: eager {decode_ms:.2f} ms (idle {decode_trace['idle_share']:.3f}, by host "
          f"clock {decode_timing['eager']['idle_share_host']:.3f}), graph "
          f"{decode_timing['graph']['us'] / 1e3:.2f} ms (idle {graph_trace['idle_share']:.3f}, by "
          f"host clock {decode_timing['graph']['idle_share_host']:.3f}), "
          f"{decode_launches:g} device activities per eager step; decode plan init with the "
          f"capture {decode_timing['init_us'] / 1e3:.1f} ms", flush=True)
    for label, b in (("prefill 2048", prefill_trace), ("decode step eager", decode_trace),
                     ("decode step graph", graph_trace)):
        top = ", ".join(f"{short_kernel_name(k['name'])} x{k['launches_per_cycle']:g} "
                        f"{k['us_per_cycle']:.0f}us" for k in b["kernels"][:6])
        print(f"rwkv {label} breakdown: window {b['window_us_per_cycle']:.0f} us, device busy "
              f"{b['busy_us_per_cycle']:.0f} us, idle share {b['idle_share']:.3f}; {top}",
              flush=True)
    out = dict(
        model="rwkv6-1.6b", layers=cfg.n_layers, n_params=n_params, param_gb=param_gb,
        init_s=init_s, slots=RWKV_SLOTS, max_len=RWKV_MAX_LEN, prompt_lengths=list(RWKV_LENGTHS),
        prefills=st.prefills, decode_steps=st.decode_steps, plan_inits=st.plan_inits,
        plan_hits=st.plan_hits, launches=launches, tokens=n_tokens, serve_s=serve_s,
        tokens_per_s=n_tokens / serve_s, plain_serve_s=plain_s, equal_requests_bf16=equal,
        first_differences_bf16=ties, prefill_logits_bf16=prefill_gap, path_check=path_err,
        equal_requests_f32=equal32, near_ties_f32=ties32, prefill_logit_err_f32=logit_err32,
        prefill_ms=prefill_ms, eager_decode_serve_s=eager_s,
        decode_ms=decode_ms, decode_graph_ms=decode_timing["graph"]["us"] / 1e3,
        decode_timing=decode_timing, decode_device_activities=decode_launches,
        prefill_idle_share=prefill_trace["idle_share"], decode_idle_share=decode_trace["idle_share"],
        decode_graph_idle_share=graph_trace["idle_share"],
        prefill_trace=prefill_trace, decode_trace=decode_trace, decode_graph_trace=graph_trace,
    )
    print("rwkv serving:", json.dumps({k: v for k, v in out.items() if not k.endswith("_trace")}),
          flush=True)

    # -- H3: sequence-parallel rwkv6-1.6b on a virtual ring of 8 ranks ---------
    t0 = time.perf_counter()
    try:
        ring = ring_lm.rwkv_ring(torch, dev, model, params, params32)
    except ring_lm.PhaseFailure as e:
        fail(f"phase H (rwkv6-1.6b): {e}")
    del params32
    ring["phase_s"] = time.perf_counter() - t0
    add_launches(kernels["wkv_chunked"], "sequence-parallel logits, rwkv6-1.6b (H3)",
                 sum(n for k, n in ring["launches"].items() if not k.endswith("local")))
    a2a = {k: sum(c.get(k, 0) for c in ring["all_to_all_launches"].values())
           for k in ("copy_convert", "gather_pack")}
    for kname, n in a2a.items():
        add_launches(kernels[kname], "message_all_to_all (H3)", n)
    print(f"phase H (rwkv6-1.6b) took {ring['phase_s']:.1f} s", flush=True)
    out["ring"] = ring
    return out


def sweep_phase(torch, dev, out_dir: pathlib.Path) -> dict:
    """Phase E: the §VI sweep on the card (see the module docstring)."""
    import dataclasses
    import tempfile

    from repro_torch.core import autotune
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.transport import get_packer
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil27.ref import jacobi_weights
    from repro_torch.stencil import Domain, StrategyConfig, comb, make_driver
    from repro_torch.stencil import sweep
    from repro_torch.stencil.heat3d import DOMAIN_AXES, heat3d_update
    from sweep_table import table

    clock, out = {}, {}

    # -- E1: the smoke grid on the card, then on the CPU --------------------
    t0 = time.perf_counter()
    smoke = sweep.smoke_config(4)
    card = sweep.sweep_cells(smoke, device=dev)
    cpu = sweep.sweep_cells(smoke, device="cpu")
    static = ("collective_count", "wire_bytes", "message_bytes", "intra_node_sends",
              "inter_node_sends")
    coords = ("strategy", "packer", "coalesce", "n_parts", "mapping", "mesh_shape")
    if len(card) != len(cpu) or not card:
        fail(f"smoke grid: {len(card)} card records, {len(cpu)} CPU records")
    lossy_err = 0.0
    for a, b in zip(card, cpu):
        cell = {k: a[k] for k in coords}
        if cell != {k: b[k] for k in coords}:
            fail(f"smoke grid: card cell {cell} beside CPU cell {[b[k] for k in coords]}")
        if {k: a[k] for k in static} != {k: b[k] for k in static}:
            fail(f"smoke grid {cell}: card {[a[k] for k in static]} != CPU {[b[k] for k in static]}")
        if get_packer(a["packer"]).wire_tolerance("float32") == (0.0, 0.0):
            if a["checksum"] != b["checksum"]:
                fail(f"smoke grid {cell}: card checksum {a['checksum']!r} != CPU {b['checksum']!r}")
        else:
            lossy_err = max(lossy_err, abs(a["checksum"] - b["checksum"]))
    clock["smoke_s"] = time.perf_counter() - t0
    print(f"sweep smoke grid: {len(card)} cells on {card[0]['device']} equal the CPU's "
          f"({', '.join(static)}; exact packers' checksums bitwise; lossy packers' checksums "
          f"differ by at most {lossy_err!r}) in {clock['smoke_s']:.1f} s", flush=True)

    # -- E2: the card grid, launch counts per cell ---------------------------
    grid = sweep.SweepConfig(device_counts=SWEEP_COUNTS, part_counts=(1, 2, 4),
                             sizes=SWEEP_SIZES, packers=("slice", "cuda"), mesh_ndim=2,
                             n_cycles=SWEEP_CYCLES, repeats=SWEEP_REPEATS)
    cell_launches = []
    run_cycles = comb.run_cycles

    def counted(driver, x, **kw):
        _build.reset_launches()
        res = run_cycles(driver, x, **kw)
        torch.cuda.synchronize()
        cell_launches.append(dict(_build.LAUNCHES))
        return res

    t0 = time.perf_counter()
    comb.run_cycles = counted
    try:
        records = sweep.run_sweep(grid, device=dev)
    finally:
        comb.run_cycles = run_cycles
    clock["grid_s"] = time.perf_counter() - t0
    if len(records) != len(cell_launches):
        fail(f"sweep grid: {len(records)} records, {len(cell_launches)} counted cells")
    totals: dict[str, int] = {}
    for r, launched in zip(records, cell_launches):
        r["launches"] = launched
        want = set()
        if r["packer"] == "cuda":
            want = {"copy_convert", "gather_pack"} if r["coalesce"] else {"copy_convert"}
        got = {k for k, v in launched.items() if v > 0}
        if got != want:
            fail(f"sweep grid {r['strategy']}@{r['packer']} coalesce={r['coalesce']} "
                 f"p{r['n_parts']} {r['global_interior']} on {r['mesh_shape']}: launched "
                 f"{launched}, expected {sorted(want)}")
        if not math.isfinite(r["checksum"]) or r["device"] != torch.cuda.get_device_name(dev):
            fail(f"sweep grid record {r['strategy']}: checksum {r['checksum']} device {r['device']}")
        for k, v in launched.items():
            totals[k] = totals.get(k, 0) + v
    # comb_measure held every cell's last block against its slab's first
    # cell (standard@slice) with torch.equal; each cuda cell's checksum must
    # also equal its slice twin's, from the same start
    def twin_key(r):
        return (r["n_devices"], tuple(r["global_interior"]), r["mapping"], r["strategy"],
                r["coalesce"], r["n_parts"])

    slice_sums = {twin_key(r): r["checksum"] for r in records if r["packer"] == "slice"}
    pairs = 0
    for r in records:
        if r["packer"] == "cuda":
            if slice_sums.get(twin_key(r)) != r["checksum"]:
                fail(f"sweep grid {twin_key(r)}: cuda checksum {r['checksum']!r} != slice "
                     f"{slice_sums.get(twin_key(r))!r}")
            pairs += 1
    slabs = len({twin_key(r)[:3] for r in records})
    if pairs == 0 or pairs != len(records) - len(slice_sums):
        fail(f"sweep grid: {pairs} cuda/slice pairs among {len(records)} records")
    bench = out_dir / "BENCH_torch_stencil_sweep.json"
    sweep.write_bench_json([{k: v for k, v in r.items() if k != "launches"} for r in records],
                           str(bench), config=sweep.config_block(grid, device=dev))
    for row in sweep.summarize(records):
        print(row)
    print(table(records))
    print(f"sweep grid: {len(records)} records -> {bench.relative_to(ROOT)} in "
          f"{clock['grid_s']:.1f} s; launches {totals} (copy_convert on every cuda cell, "
          f"gather_pack on every coalesced one, none on slice); {len(records) - slabs} cells' "
          f"last blocks bitwise-equal to their slab's first (torch.equal), {pairs} cuda cells' "
          f"checksums equal to their slice twins'", flush=True)
    out.update(grid=dataclasses.asdict(grid), launches=totals, bitwise_cells=len(records) - slabs,
               checksum_pairs=pairs,
               cell_launches=[[r["strategy"], r["packer"], r["coalesce"], r["n_parts"],
                               r["global_interior"], r["launches"]] for r in records])

    # where an exchange-only cycle's time goes in the grid's largest cell
    # (packer cuda, coalesced; torch.profiler over 3 cycles)
    t0 = time.perf_counter()
    bdom = Domain(make_mesh((4, 2), ("px", "py"), device=dev), GLOBAL_INTERIOR,
                  ("px", "py", None))
    x = bdom.random(0)
    breakdown = {}
    for name in grid.strategies:
        drv = make_driver(StrategyConfig(name=name, packer="cuda",
                                         n_parts=4 if name == "partitioned" else 1),
                          bdom.mesh, bdom.halo_spec, ndim=3)
        x = drv.wait(drv.step(x))
        b = breakdown[name] = comb.device_breakdown(drv, x)
        drv.free()
        top = ", ".join(f"{short_kernel_name(k['name'])} x{k['launches_per_cycle']:g} "
                        f"{k['us_per_cycle']:.0f}us" for k in b["kernels"][:5])
        print(f"sweep {name}@cuda {GLOBAL_INTERIOR} on (4, 2) breakdown: window "
              f"{b['window_us_per_cycle']:.0f} us/cycle, device busy {b['busy_us_per_cycle']:.0f} "
              f"us, idle share {b['idle_share']:.3f}; {top}", flush=True)
    del x
    clock["breakdown_s"] = time.perf_counter() - t0
    out["breakdown"] = breakdown

    # -- E3: auto at the heat3d layout: trace, calibration, cache ------------
    t0 = time.perf_counter()
    dom = Domain(make_mesh(*MESH, device=dev), GLOBAL_INTERIOR, DOMAIN_AXES)
    update = heat3d_update(jacobi_weights().numpy(), dev)
    auto = StrategyConfig(name="auto", packer="auto", coalesce="auto")
    cell = [r for r in records if r["n_devices"] == 8 and r["message_bytes"] == dom.max_face_bytes()
            and r["node_size"] == 4 and tuple(r["mesh_shape"]) == MESH[0]]
    if len(cell) != 28:
        fail(f"auto: the trace holds {len(cell)} records of the heat3d cell, not 28")
    best = min(cell, key=lambda r: r["us_per_cycle"])
    saved = {k: os.environ.get(k) for k in (autotune.TRACE_ENV, autotune.CACHE_ENV)}
    runs = {}
    x0 = dom.random(0)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for run, trace, cache, want in (
                    ("trace", str(bench), "trace_cache.json", "trace"),
                    ("calibration", None, "cache.json", "calibration"),
                    ("cache", None, "cache.json", "cache")):
                if trace is None:
                    os.environ.pop(autotune.TRACE_ENV, None)
                else:
                    os.environ[autotune.TRACE_ENV] = trace
                os.environ[autotune.CACHE_ENV] = os.path.join(tmp, cache)
                autotune.reset_default_tuners()
                drv = make_driver(auto, dom.mesh, dom.halo_spec, ndim=3, update_fn=update)
                x = x0.clone()
                t1 = time.perf_counter()
                drv.init(x)
                resolve_s = time.perf_counter() - t1
                _build.reset_launches()
                for _ in range(AUTO_CYCLES):
                    x = drv.step(x)
                x = drv.wait(x)
                launched = dict(_build.LAUNCHES)
                picked = (drv.strategy, drv.config.packer, drv.config.coalesce, drv.n_parts)
                static_drv = make_driver(StrategyConfig(
                    name=picked[0], packer=picked[1], coalesce=picked[2], n_parts=picked[3]),
                    dom.mesh, dom.halo_spec, ndim=3, update_fn=update)
                y = x0.clone()
                for _ in range(AUTO_CYCLES):
                    y = static_drv.step(y)
                y = static_drv.wait(y)
                equal = torch.equal(x, y)
                drv.free()
                static_drv.free()
                del x, y
                runs[run] = dict(selected_by=drv.selected_by, candidate=list(picked),
                                 predicted_us=drv.predicted_us, calibration_us=drv.calibration_us,
                                 resolve_s=resolve_s, launches=launched)
                print(f"auto ({run}): {drv.selected_by} -> {picked}, predicted_us="
                      f"{drv.predicted_us!r}, calibration_us={drv.calibration_us!r}, resolve+init "
                      f"{resolve_s:.2f} s, launches {launched}, {AUTO_CYCLES} cycles bitwise-equal "
                      f"to the static driver: {equal}", flush=True)
                if drv.selected_by != want:
                    fail(f"auto ({run}): selected_by {drv.selected_by!r}, expected {want!r}")
                if not equal:
                    fail(f"auto ({run}): cycles differ from the static {picked} driver's")
                if launched.get("stencil27", 0) < AUTO_CYCLES or (
                        picked[1] == "cuda" and launched.get("copy_convert", 0) <= 0):
                    fail(f"auto ({run}): launches {launched} on {picked}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.reset_default_tuners()
    want = [best["strategy"], best["packer"], best["coalesce"], best["n_parts"]]
    if runs["trace"]["candidate"] != want or runs["trace"]["predicted_us"] != best["us_per_cycle"]:
        fail(f"auto (trace): {runs['trace']} is not the cell's argmin {want} "
             f"({best['us_per_cycle']} us)")
    if runs["cache"]["candidate"] != runs["calibration"]["candidate"]:
        fail(f"auto (cache): {runs['cache']['candidate']} != calibration's "
             f"{runs['calibration']['candidate']}")
    clock["auto_s"] = time.perf_counter() - t0
    print(f"auto at the heat3d layout: trace picks the argmin {want} of the cell's 28 records, "
          f"calibration picks {runs['calibration']['candidate']} in "
          f"{runs['calibration']['calibration_us'] / 1e6:.2f} s, the cache replays it; phase E "
          f"clock {json.dumps({k: round(v, 1) for k, v in clock.items()})}", flush=True)
    out.update(auto=runs, clock=clock, smoke_cells=len(card), records=len(records))
    return out


def grid_worker(out_path: str) -> int:
    """One process of phase F's grid (``python3 chip_smoke.py --grid-worker
    OUT``, booted by :func:`grid_phase` through ``launch_grid``): the heat3d
    layout, this process's ranks on ``cuda:0``; writes its results to
    ``OUT/phase_f_rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.stencil import maybe_initialize_from_env

    rank = maybe_initialize_from_env()
    import torch

    from repro_torch.core import transport
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.launch.mapping import mesh_node_ids
    from repro_torch.stencil import Domain, StrategyConfig, make_driver, reference_exchange
    from repro_torch.stencil.comb import run_cycles
    from repro_torch.stencil.heat3d import DOMAIN_AXES

    dev = torch.device("cuda", torch.cuda.current_device())
    strategies = ("standard", "persistent", "partitioned", "fused", "overlap")

    def config(name, transport_name):
        return StrategyConfig(name=name, packer="cuda", coalesce=True, transport=transport_name,
                              n_parts=4 if name == "partitioned" else 1)

    def grid_mesh():
        return make_mesh(*MESH, device=dev, processes=GRID_PROCESSES, process_index=rank)

    out = {"rank": rank, "device": torch.cuda.get_device_name(dev)}
    # the port's reference roll at 64^3, this process's rows
    small = Domain(grid_mesh(), GRID_REF_SIZE, DOMAIN_AXES)
    interior = torch.randn(GRID_REF_SIZE, generator=torch.Generator().manual_seed(1))
    want = reference_exchange(small, interior)
    out["reference"] = {}
    for name in strategies:
        drv = make_driver(config(name, "multihost"), small.mesh, small.halo_spec, ndim=3)
        got = drv.wait(drv.step(small.from_global_interior(interior)))
        out["reference"][name] = torch.equal(got, want)
        drv.free()
    del want, got

    # the heat3d layout: the grid's rows against a one-process loopback run
    one = Domain(make_mesh(*MESH, device=dev), GLOBAL_INTERIOR, DOMAIN_AXES)
    grid = Domain(grid_mesh(), GLOBAL_INTERIOR, DOMAIN_AXES)
    rows = list(grid.mesh.local_coords)
    local = grid.local_ghosted
    t0 = time.perf_counter()
    x1 = one.random(0)
    xg = grid.random(0)
    out["random_s"] = time.perf_counter() - t0
    out["coords"] = rows
    out["random_rows_equal"] = torch.equal(x1.view(-1, *local)[rows], xg)
    node_of = mesh_node_ids(grid.mesh, grid.mesh.local_size)  # a node is a process
    cells = {}
    for name in strategies:
        d1 = make_driver(config(name, "loopback"), one.mesh, one.halo_spec, ndim=3)
        ref = d1.wait(d1.step(x1.clone())).reshape(-1, *local)[rows].clone()
        d1.free()
        torch.cuda.empty_cache()
        drv = make_driver(config(name, "multihost"), grid.mesh, grid.halo_spec, ndim=3)
        _build.reset_launches()
        res, final = run_cycles(drv, xg.clone(), n_cycles=GRID_CYCLES, repeats=GRID_REPEATS,
                                return_final=True)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        equal = torch.equal(final, ref)
        # host staging: a window of GRID_CYCLES cycles with the clocks zeroed
        transport.reset_staging()
        import torch.distributed as dist

        dist.barrier()
        x = final
        t0 = time.perf_counter()
        for _ in range(GRID_CYCLES):
            x = drv.step(x)
        x = drv.wait(x)
        window = time.perf_counter() - t0
        staging = dict(transport.STAGING_SECONDS)
        groups = drv.replan_tables(xg)[0]
        loc = transport.schedule_locality(groups, axis_order=grid.mesh.axis_names,
                                          axis_sizes=grid.mesh.shape, node_of=node_of)
        plan = getattr(drv, "plan", None)
        cells[name] = dict(
            us_per_cycle=res.us_per_cycle, init_us=res.init_us, checksum=res.checksum,
            process_count=res.process_count, bitwise_vs_one_process=equal, launches=launches,
            captured=plan is not None and plan.captured,
            window_us_per_cycle=window / GRID_CYCLES * 1e6,
            staging_us_per_cycle={k: v / GRID_CYCLES * 1e6 for k, v in staging.items()},
            staging_share=sum(staging.values()) / window,
            intra_node_sends=loc.intra_sends, inter_node_sends=loc.inter_sends,
        )
        drv.free()
        del ref, final, x
        torch.cuda.empty_cache()
    out["cells"] = cells
    pathlib.Path(out_path, f"phase_f_rank{rank}.json").write_text(json.dumps(out, indent=1))
    return 0


def grid_phase(torch, dev, out_dir: pathlib.Path) -> dict:
    """Phase F: the paper's process axis on one card (see the module
    docstring)."""
    import dataclasses

    from repro_torch.core.transport import get_packer
    from repro_torch.launch.stencil import launch_grid
    from repro_torch.stencil import sweep

    clock, out = {}, {}
    # -- F1: the heat3d layout over two processes ---------------------------
    t0 = time.perf_counter()
    for r in range(GRID_PROCESSES):
        (out_dir / f"phase_f_rank{r}.json").unlink(missing_ok=True)
    res = launch_grid([sys.executable, str(ROOT / "chip_smoke.py"), "--grid-worker",
                       str(out_dir)], processes=GRID_PROCESSES, timeout=GRID_TIMEOUT,
                      check=False)
    clock["heat3d_grid_s"] = time.perf_counter() - t0
    if not res.ok:
        fail(f"grid: ranks {res.failed_ranks} failed (exit {res.returncodes}):\n"
             + "\n".join(f"--- rank {r} ---\n{res.errs[r][-3000:]}" for r in res.failed_ranks))
    ranks = [json.loads((out_dir / f"phase_f_rank{r}.json").read_text())
             for r in range(GRID_PROCESSES)]
    e_records, _ = sweep.read_bench_json(str(out_dir / "BENCH_torch_stencil_sweep.json"))

    def one_process(name, n_parts, packer="cuda", coalesce=True):
        (r,) = [r for r in e_records if r["n_devices"] == 8 and r["strategy"] == name
                and tuple(r["global_interior"]) == GLOBAL_INTERIOR and r["packer"] == packer
                and r["coalesce"] == coalesce and r["n_parts"] == n_parts]
        return r

    coords = sorted(c for w in ranks for c in w["coords"])
    if coords != list(range(8)) or not all(w["random_rows_equal"] for w in ranks):
        fail(f"grid: coordinates {[w['coords'] for w in ranks]}, Domain.random rows equal "
             f"{[w['random_rows_equal'] for w in ranks]}")
    totals: dict[str, int] = {}
    for w in ranks:
        for name, ok in w["reference"].items():
            if not ok:
                fail(f"grid rank {w['rank']} {name}: rows differ from reference_exchange at "
                     f"{GRID_REF_SIZE}")
        for name, c in w["cells"].items():
            want = {"copy_convert", "gather_pack"}
            got = {k for k, v in c["launches"].items() if v > 0}
            if not c["bitwise_vs_one_process"] or c["captured"] or got != want:
                fail(f"grid rank {w['rank']} {name}: bitwise {c['bitwise_vs_one_process']}, "
                     f"captured {c['captured']}, launches {c['launches']}")
            for k, v in c["launches"].items():
                totals[k] = totals.get(k, 0) + v
    sums = {name: {w["cells"][name]["checksum"] for w in ranks} for name in ranks[0]["cells"]}
    if any(len(v) != 1 for v in sums.values()):
        fail(f"grid: the processes' checksums differ: {sums}")
    rows = []
    for name in ranks[0]["cells"]:
        c0, c1 = (w["cells"][name] for w in ranks)
        e = one_process(name, 4 if name == "partitioned" else 1)
        staging = {k: max(w["cells"][name]["staging_us_per_cycle"].get(k, 0.0) for w in ranks)
                   for k in ("d2h", "gloo", "h2d")}
        row = dict(strategy=name, us_per_cycle=max(c0["us_per_cycle"], c1["us_per_cycle"]),
                   one_process_us=e["us_per_cycle"],
                   staging_share=max(c0["staging_share"], c1["staging_share"]),
                   staging_us_per_cycle=staging, init_us=max(c0["init_us"], c1["init_us"]),
                   # the whole mesh's static tally, the same in each process
                   intra_node_sends=c0["intra_node_sends"],
                   inter_node_sends=c0["inter_node_sends"],
                   one_process_intra_inter=[e["intra_node_sends"], e["inter_node_sends"]],
                   checksum_vs_one_process=c0["checksum"] - e["checksum"])
        rows.append(row)
        print(f"grid heat3d {name}@cuda coalesced over {GRID_PROCESSES} processes: "
              f"{row['us_per_cycle']:.1f} us/cycle (one process, graph, phase E: "
              f"{e['us_per_cycle']:.1f}); host staging {row['staging_share']:.3f} of the cycle "
              f"(us/cycle d2h {staging['d2h']:.0f}, gloo {staging['gloo']:.0f}, h2d "
              f"{staging['h2d']:.0f}); intra/inter-node sends {row['intra_node_sends']}/"
              f"{row['inter_node_sends']} (one process, modeled nodes: "
              f"{e['intra_node_sends']}/{e['inter_node_sends']}); bitwise-equal to the "
              f"one-process loopback run in both processes", flush=True)
    print(f"grid heat3d: {len(rows)} strategies x {GRID_PROCESSES} processes on "
          f"{ranks[0]['device']}, rows bitwise-equal to reference_exchange at {GRID_REF_SIZE} "
          f"and to a one-process loopback run at {GLOBAL_INTERIOR}; launches in the grid "
          f"{totals} (both processes, no plan captured); {clock['heat3d_grid_s']:.1f} s",
          flush=True)
    out.update(heat3d=rows, launches=totals, workers=ranks)

    # -- F2: phase E's 8-rank slab with --processes 2 ------------------------
    t0 = time.perf_counter()
    config = sweep.SweepConfig(device_counts=(8,), part_counts=P2_PARTS, sizes=SWEEP_SIZES,
                               packers=("slice", "cuda"), mesh_ndim=2, n_cycles=P2_CYCLES,
                               repeats=P2_REPEATS, processes=GRID_PROCESSES,
                               transport="multihost")
    records = sweep.run_sweep(config, device=dev, timeout=GRID_TIMEOUT)
    clock["p2_sweep_s"] = time.perf_counter() - t0
    if len(records) != len(SWEEP_SIZES) * 4 * (4 + len(P2_PARTS)):
        fail(f"p2 sweep: {len(records)} records")
    worst = 0.0
    for r in records:
        if (r["process_count"] != GRID_PROCESSES or not r["is_multihost"]
                or r["device"] != torch.cuda.get_device_name(dev) or not math.isfinite(r["checksum"])):
            fail(f"p2 sweep record {r['strategy']} {r['global_interior']}: {r}")
        e = one_process(r["strategy"], r["n_parts"], r["packer"], r["coalesce"]) \
            if tuple(r["global_interior"]) == GLOBAL_INTERIOR else None
        if e is not None and get_packer(r["packer"]).wire_tolerance("float32") == (0.0, 0.0):
            worst = max(worst, abs(r["checksum"] - e["checksum"]) / abs(e["checksum"]))
    if worst > 1e-12:
        fail(f"p2 sweep: checksums differ from the one-process grid's by {worst} (relative)")
    bench = out_dir / "BENCH_torch_stencil_sweep_p2.json"
    sweep.write_bench_json(records, str(bench), config=sweep.config_block(config, device=dev))
    for row in sweep.summarize(records):
        print(row)
    print(f"p2 sweep: {len(records)} records over {GRID_PROCESSES} processes -> "
          f"{bench.relative_to(ROOT)} in {clock['p2_sweep_s']:.1f} s; every exact cell's last "
          f"block bitwise-equal to its slab's first across both processes (comb_measure), "
          f"checksums within {worst!r} (relative) of the one-process grid's at "
          f"{GLOBAL_INTERIOR}; phase F clock {json.dumps({k: round(v, 1) for k, v in clock.items()})}",
          flush=True)
    out.update(p2_records=len(records), p2_checksum_rel=worst, clock=clock,
               p2_config=dataclasses.asdict(config))
    return out


def elastic_config(**kw):
    """Phase G's cell: the heat3d size on the runner's 1-axis mesh
    ``("px",)``, packer ``cuda``, coalesced, ``persistent``."""
    from repro_torch.launch.elastic import ElasticConfig

    return ElasticConfig(global_interior=GLOBAL_INTERIOR, n_steps=ELASTIC_STEPS,
                         strategy="persistent", packer="cuda", coalesce=True, **kw)


def elastic_worker(ckpt_dir: str, out_dir: str) -> int:
    """One process of leg G4's grid (``python3 chip_smoke.py
    --elastic-worker CKPT OUT``, booted by :func:`elastic_phase` through
    ``launch_grid``): 4 ranks of an 8-rank mesh on ``cuda:0``, transport
    ``multihost``, ``max_replans=0``; process 1 fails mid-exchange at step
    ``GRID_FAIL``.  Whatever ends its run, it writes its launches and
    events to ``OUT/phase_g_rank<r>.json``; a run that ends cleanly exits
    17."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.stencil import maybe_initialize_from_env

    rank = maybe_initialize_from_env()
    import dataclasses

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.elastic import ElasticStencilRunner
    from repro_torch.train.fault_tolerance import FailureInjector

    _build.reset_launches()
    runner = ElasticStencilRunner(
        elastic_config(checkpoint_every=GRID_EVERY, transport="multihost", max_replans=0),
        ckpt_dir, device=torch.device("cuda", torch.cuda.current_device()),
        devices=list(range(8)),
        injector=FailureInjector(fail_at_steps=(GRID_FAIL,) if rank == 1 else (),
                                 phases=("mid-exchange",)))
    try:
        runner.run()
    finally:
        pathlib.Path(out_dir, f"phase_g_rank{rank}.json").write_text(json.dumps({
            "rank": rank, "launches": dict(_build.LAUNCHES),
            "events": [dataclasses.asdict(e) for e in runner.events],
            "save_s": runner.save_seconds, "checkpoint_step": runner.checkpoint_step,
            "captured": [p.captured for p in runner.cache._plans.values()]}))
    print(f"rank {rank}: survived a run that should have died", flush=True)
    return 17


def elastic_phase(torch, dev, out_dir: pathlib.Path) -> dict:
    """Phase G: elastic recovery at the heat3d size (see the module
    docstring)."""
    import dataclasses
    import shutil

    import numpy as np

    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.launch.elastic import ElasticStencilRunner
    from repro_torch.launch.membership import MembershipClient, MembershipServer, MembershipService
    from repro_torch.launch.stencil import launch_grid
    from repro_torch.stencil import Domain, StrategyConfig, make_driver
    from repro_torch.train import checkpoint
    from repro_torch.train.fault_tolerance import FailureInjector

    card, power = (part.strip() for part in nvidia_smi_line().split(","))
    # an 8-rank block set: what a dead 8-rank plan must give back
    block_bytes = 8 * (GLOBAL_INTERIOR[0] // 8 + 2) * math.prod(GLOBAL_INTERIOR[1:]) * 4
    clock, rows = {}, []
    t0 = time.perf_counter()
    oracle = ElasticStencilRunner(elastic_config(checkpoint_every=0), None, device=dev,
                                  devices=[0]).run()
    clock["oracle_s"] = time.perf_counter() - t0
    want = oracle.final_interior
    if want.shape != GLOBAL_INTERIOR or not np.isfinite(want).all():
        fail(f"elastic oracle: shape {want.shape}, finite {np.isfinite(want).all()}")
    print(f"elastic oracle: 1 rank, {ELASTIC_STEPS} steps at {GLOBAL_INTERIOR} f32 in "
          f"{clock['oracle_s']:.1f} s (init_us with the capture "
          f"{oracle.events[0].init_us:.0f})", flush=True)
    del oracle

    def ckpt_dir(leg):
        d = ROOT / "build" / f"elastic_{leg}"
        shutil.rmtree(d, ignore_errors=True)
        return d

    def check(leg, result, launches, causes, ranks):
        if [e.cause for e in result.events] != causes or [e.n_devices for e in result.events] != ranks:
            fail(f"{leg}: events {result.events}")
        if result.steps != ELASTIC_STEPS or not np.array_equal(result.final_interior, want):
            fail(f"{leg}: {result.steps} steps; final interior bitwise-equal to the 1-rank "
                 f"oracle: {np.array_equal(result.final_interior, want)}")
        if launches.get("copy_convert", 0) <= 0 or launches.get("gather_pack", 0) <= 0:
            fail(f"{leg}: launches {launches}")
        for rec in result.recoveries:
            # a loss gives the dead plan's block back before the new plan
            # exists (a JOIN still holds the live copy then; a relaunched
            # process had nothing to give back); after the first step on
            # the new mesh one block set is held, not two
            back = rec.memory_at_raise - rec.memory_released
            grew = rec.memory_after - rec.memory_at_raise
            if ((rec.cause not in ("join", "resume") and back < 0.9 * block_bytes)
                    or grew > 0.1 * block_bytes):
                fail(f"{leg}: the dead plan's memory did not come back: {rec}")

    def report(leg, result, launches, **extra):
        row = {"leg": leg, **result.bench_record(), "card": card, "power_limit": power,
               "events": [dataclasses.asdict(e) for e in result.events],
               "recoveries": [{k: v for k, v in dataclasses.asdict(r).items() if k != "t_raise"}
                              for r in result.recoveries],
               "save_s": result.save_seconds, "launches": launches, **extra}
        rows.append(row)
        for e in result.events:
            print(f"{leg} plan[{e.cause}] step={e.step} ranks={e.n_devices} replan_us="
                  f"{e.replan_us:.0f} init_us(with the capture)={e.init_us:.0f} invalidated="
                  f"{e.plan_invalidations} epoch={e.epoch}", flush=True)
        for r in row["recoveries"]:
            print(f"{leg} recovery[{r['cause']}] resumed at step {r['step']}: "
                  f"{r['recover_s']:.3f} s from the raise to the end of the first step on the "
                  f"new mesh, restore {r['restore_s']:.3f} s; memory_allocated "
                  f"{r['memory_at_raise'] / 2**30:.3f} GiB at the raise, "
                  f"{r['memory_released'] / 2**30:.3f} released, "
                  f"{r['memory_after'] / 2**30:.3f} after", flush=True)
        print(f"{leg}: save_s {[round(v, 3) for v in result.save_seconds]}, join_us "
              f"{result.join_us:.0f}, warm_ranks {result.warm_ranks}, plan cache inits/hits/"
              f"invalidations {result.plan_cache_inits}/{result.plan_cache_hits}/"
              f"{result.plan_cache_invalidations}, epoch {result.final_epoch}; launches "
              f"{json.dumps(launches)}; final interior bitwise-equal to the 1-rank oracle",
              flush=True)

    def fail_at(step):
        return FailureInjector(fail_at_steps=(step,), phases=("mid-exchange",))

    # -- G1: loss, relaunch recovery -----------------------------------------
    d = ckpt_dir("g1")
    runner = ElasticStencilRunner(elastic_config(checkpoint_every=ELASTIC_EVERY), str(d),
                                  device=dev, devices=list(range(8)),
                                  injector=fail_at(ELASTIC_FAIL))
    _build.reset_launches()
    t0 = time.perf_counter()
    result = runner.run()
    clock["g1_s"] = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check("G1", result, launches, ["initial", "rank-loss"], [8, 4])
    if result.events[1].plan_invalidations != 1 or result.events[1].step != ELASTIC_EVERY:
        fail(f"G1: events {result.events}")
    report("G1 loss-relaunch", result, launches)
    shutil.rmtree(d)

    # -- G2: loss, in-grid recovery over a live membership wire --------------
    d = ckpt_dir("g2")
    svc = MembershipService(heartbeat_timeout=ELASTIC_TIMEOUT)
    with MembershipServer(svc, host="127.0.0.1") as srv:
        cli = MembershipClient(srv.address, timeout=30.0)
        runner = ElasticStencilRunner(
            elastic_config(checkpoint_every=ELASTIC_EVERY, recovery_mode="in-grid",
                           heartbeat_timeout=ELASTIC_TIMEOUT),
            str(d), device=dev, devices=list(range(8)), injector=fail_at(ELASTIC_FAIL),
            membership=cli)
        # an unrelated plan, warmed beforehand, must stay in the cache
        small = Domain(make_mesh((2,), ("px",), device=dev), (64, 64, 64), ("px", None, None))
        warm = make_driver(StrategyConfig(name="persistent", packer="cuda", plan_cache=runner.cache),
                           small.mesh, small.halo_spec, ndim=3)
        warm.init(small.random(0))
        warm.free()
        warm_keys, inits_before = set(runner.cache.keys()), runner.cache.stats.inits
        _build.reset_launches()
        t0 = time.perf_counter()
        result = runner.run()
        clock["g2_s"] = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        view = cli.view()
    check("G2", result, launches, ["initial", "loss-ingrid"], [8, 4])
    if (not warm_keys <= set(runner.cache.keys()) or result.warm_ranks != 4
            or result.plan_cache_inits != inits_before + 2 or result.final_epoch != 1
            or result.events[1].plan_invalidations != 1
            or (view.epoch, view.cause, len(view.members)) != (1, "loss", 4)):
        fail(f"G2: warm plan kept {warm_keys <= set(runner.cache.keys())}, warm_ranks "
             f"{result.warm_ranks}, inits {inits_before} -> {result.plan_cache_inits}, "
             f"events {result.events}, view {view}")
    report("G2 loss-ingrid", result, launches, membership=view.to_wire())
    runner.cache.free_all()
    shutil.rmtree(d)

    # -- G3: JOIN, 4 -> 8 ranks, live state, no checkpoint -------------------
    runner = ElasticStencilRunner(elastic_config(checkpoint_every=0, recovery_mode="in-grid"),
                                  None, device=dev, devices=list(range(4)),
                                  joins=[(JOIN_STEP, list(range(4, 8)))])
    _build.reset_launches()
    t0 = time.perf_counter()
    result = runner.run()
    clock["g3_s"] = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check("G3", result, launches, ["initial", "join"], [4, 8])
    if (result.replans, result.warm_ranks, result.final_epoch, result.checkpoint_step) != (
            0, 4, 4, None) or result.join_us <= 0:
        fail(f"G3: {result}")
    report("G3 join", result, launches)

    # -- G4: a 2-process grid dies; one process resumes on its graph ---------
    d = ckpt_dir("g4")
    for r in range(GRID_PROCESSES):
        (out_dir / f"phase_g_rank{r}.json").unlink(missing_ok=True)
    _build.reset_launches()
    t0 = time.perf_counter()
    grid = launch_grid([sys.executable, str(ROOT / "chip_smoke.py"), "--elastic-worker", str(d),
                        str(out_dir)], processes=GRID_PROCESSES, timeout=ELASTIC_TIMEOUT,
                       check=False, attempts=1)
    clock["g4_grid_s"] = time.perf_counter() - t0
    committed = checkpoint.committed_steps(str(d))
    if (grid.ok or 17 in grid.returncodes or "SimulatedFailure" not in grid.errs[1]
            or committed != [GRID_EVERY]):
        fail(f"G4: grid exit {grid.returncodes}, committed {committed}:\n"
             + "\n".join(f"--- rank {r} ---\n{e[-3000:]}" for r, e in enumerate(grid.errs)))
    workers = [json.loads(f.read_text()) for f in sorted(out_dir.glob("phase_g_rank*.json"))]
    dead = next(w for w in workers if w["rank"] == 1)
    if (dead["launches"].get("copy_convert", 0) <= 0 or dead["launches"].get("gather_pack", 0) <= 0
            or any(dead["captured"]) or dead["events"][0]["n_devices"] != 8):
        fail(f"G4: the failing process's record {dead}")
    print(f"G4 grid: {GRID_PROCESSES} processes x 4 ranks died in {clock['g4_grid_s']:.1f} s "
          f"(exit {grid.returncodes}); step {GRID_EVERY}'s commit survived; launches per process "
          f"{[w['launches'] for w in workers]}, plans eager (captured {dead['captured']}), "
          f"save_s {[w['save_s'] for w in workers]}", flush=True)
    t0 = time.perf_counter()
    runner = ElasticStencilRunner(
        elastic_config(checkpoint_every=GRID_EVERY, transport="multihost", max_replans=0),
        str(d), device=dev, devices=list(range(4)))
    result = runner.run()
    clock["g4_resume_s"] = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check("G4", result, launches, ["initial"], [4])
    if (result.events[0].step != GRID_EVERY or [r.cause for r in result.recoveries] != ["resume"]
            or not all(p.captured for p in runner.cache._plans.values())):
        fail(f"G4: the resume {result.events} {result.recoveries}")
    report("G4 grid relaunch", result, launches, grid_s=clock["g4_grid_s"],
           grid_returncodes=list(grid.returncodes), grid_workers=workers)
    runner.cache.free_all()
    shutil.rmtree(d)

    bench = out_dir / "BENCH_torch_elastic.json"
    bench.write_text(json.dumps({"card": card, "power_limit": power, "torch": torch.__version__,
                                 "global_interior": list(GLOBAL_INTERIOR), "steps": ELASTIC_STEPS,
                                 "clock": clock, "records": rows}, indent=1) + "\n")
    print(f"elastic: 4 legs bitwise-equal to the 1-rank oracle at {GLOBAL_INTERIOR} -> "
          f"{bench.relative_to(ROOT)}; phase G clock "
          f"{json.dumps({k: round(v, 1) for k, v in clock.items()})}", flush=True)
    return {"records": rows, "clock": clock}


def main() -> int:
    import contextlib
    import io

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
    sys.path.insert(0, str(ROOT / "tools"))  # the timing helpers the tools share
    import torch.nn.functional as F
    from time_plan_graph import driver_steps, eager_vs_graph

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
    t_main = time.perf_counter()
    t_lap = [t_main]
    phase_s: dict[str, float] = {}
    #: the bytes still allocated on the card after each phase: what it
    #: leaves the later ones (N4's peak needs all but a few GB of the card)
    phase_allocated: dict[str, int] = {}

    def lap(name: str) -> None:
        """The seconds since the last lap (or the start) and the bytes still
        allocated: printed and recorded under ``phase_s`` and
        ``phase_allocated``."""
        now = time.perf_counter()
        phase_s[name] = now - t_lap[0]
        t_lap[0] = now
        phase_allocated[name] = torch.cuda.memory_allocated()
        print(f"chip_smoke: {name} took {phase_s[name]:.1f} s, "
              f"{phase_allocated[name] / 1e9:.3f} GB allocated after it", flush=True)

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):  # nvcc -Xptxas -v: registers, spills
        libs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    smi = nvidia_smi_line()
    print(f"build: {sorted(libs)} in {build_s:.1f} s; card: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    record.update(build_s=build_s, card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  build_log=log.getvalue())

    mesh = make_mesh(*MESH, device=dev)
    dom = Domain(mesh, GLOBAL_INTERIOR, DOMAIN_AXES)
    ranks, local = mesh.size, dom.local_ghosted
    print(f"domain {GLOBAL_INTERIOR} on mesh {mesh.shape}: block {local} per rank, "
          f"faces {dom.face_bytes()} bytes", flush=True)
    t0 = time.perf_counter()
    x = dom.random(0)
    torch.cuda.synchronize()
    random_s = time.perf_counter() - t0
    print(f"Domain.random at {GLOBAL_INTERIOR}: {random_s:.2f} s (one seeded host draw and "
          f"its upload)", flush=True)
    xb = x.view(ranks, *local)
    l2_flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    flush = l2_flush.zero_
    kernels: dict[str, dict] = {}

    def bound_ms(nbytes: int) -> float:
        return nbytes / HBM_BYTES_PER_S * 1e3

    lap("1 build, domain")
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
    # the scalar path (a window starting 4 bytes past a vector, rows of 510)
    # and the vector path's tail (aligned rows of 512, runs of 510), pack,
    # unpack and window to window
    for label, ws in (("misaligned", (slice(1, 2), slice(3, 500), slice(1, 511))),
                      ("ragged run", (slice(1, 2), slice(3, 500), slice(0, 510)))):
        win = xb[(slice(None), *ws)]
        for wire, scale in ((torch.float32, 1.0), (torch.bfloat16, 8.0)):
            buf = torch.empty(win.shape, dtype=wire, device=dev)
            pack_k.copy_convert(win, buf, scale=scale)
            want = pack_2d_ref(win, out_dtype=wire, scale=scale)
            ghost = torch.zeros((ranks, 2, 514, 512), device=dev)[(slice(None), slice(1, 2), *ws[1:])]
            pack_k.copy_convert(buf, ghost, scale=1.0 / scale if scale != 1.0 else 1.0)
            want_back = unpack_2d_ref(want, out_dtype=torch.float32, scale=scale)
            other = torch.zeros((ranks, 2, 514, 512), dtype=wire, device=dev)
            owin = other[(slice(None), slice(1, 2), *ws[1:])]
            pack_k.copy_convert(win, owin, scale=scale)
            torch.cuda.synchronize()
            err = max((buf.float() - want.float()).abs().max().item(),
                      (ghost - want_back).abs().max().item())
            exact = (torch.equal(buf, want) and torch.equal(ghost, want_back)
                     and torch.equal(owin, want))
            owin.zero_()  # nothing may have been written outside the window
            if not exact or other.any():
                fail(f"copy_convert {label} window {tuple(win.shape)} {wire} scale={scale}: "
                     f"max err {err}")
            worst = max(worst, err)
            print(f"copy_convert {label} window {tuple(win.shape)} f32->{str(wire)[6:]} "
                  f"scale={scale}, pack, unpack and window to window: exact", flush=True)
            del buf, want, ghost, want_back, other, owin
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
        device_ms=device_ms(torch, lambda: pack_k.copy_convert(win, buf), flush=flush),
        library_device_ms=device_ms(torch, lambda: buf.copy_(win), flush=flush),
        timing="ms, plain_ms, library_ms: CUDA events around one call after an L2 flush "
               "(the wrapper's host time inside); device_ms, library_device_ms: torch.profiler "
               "device time of the same calls",
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
    # segments off the main path: ragged rows one element past a vector, an
    # x face (rows of one element), a corner cell, a whole face cut into chunks
    segs, seg_total = [], 0
    for start, shape in (((1, 3, 5), (1, 7, 507)), ((0, 0, 1), (3, 1, 1)),
                         ((2, 1, 0), (2, 3, 512)), ((5, 2, 511), (4, 510, 1)),
                         ((257, 513, 511), (1, 1, 1)), ((5, 0, 3), (1, 514, 509))):
        segs.append((seg_total, start, shape))
        seg_total += math.prod(shape)
    table = pack_k.segment_table(segs, local, dev)
    for wire, scale in ((torch.float32, 1.0), (torch.bfloat16, 8.0)):
        out = torch.empty((ranks, seg_total), dtype=wire, device=dev)
        pack_k.gather_pack(xb, table, out, scale=scale)
        want = gather_pack_ref(xb, segs, total=seg_total, out_dtype=wire, scale=scale)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        if not torch.equal(out, want):
            fail(f"gather_pack ragged/misaligned/edge segments {wire} scale={scale}: err {err}")
        worst = max(worst, err)
    del out, want
    print(f"gather_pack: {len(layouts)} layouts x (f32, bf16) wire, and ragged, misaligned, "
          f"x-face and corner segments (f32; bf16 at scale 8): exact", flush=True)
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
        ms=time_ms(torch, lambda: pack_k.gather_pack(xb, table, out), flush=flush, reps=21),
        plain_ms=time_ms(torch, lambda: gather_pack_ref(xb, lay.segments, total=lay.total), flush=flush),
        bound_ms=bound_ms(2 * ranks * lay.total * 4), bound_by="bytes",
        library_ms=time_ms(torch, lambda: torch.index_select(xflat, 1, flat_idx), flush=flush,
                           reps=21),
        device_ms=device_ms(torch, lambda: pack_k.gather_pack(xb, table, out), flush=flush),
        library_device_ms=device_ms(torch, lambda: torch.index_select(xflat, 1, flat_idx),
                                    flush=flush),
        timing="ms, plain_ms, library_ms: CUDA events around one call after an L2 flush "
               "(the wrapper's host time inside; ms and library_ms median of 21); device_ms, "
               "library_device_ms: torch.profiler device time of the same calls",
        segments=len(lay.segments), total=lay.total, chunks=table.shape[0],
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
    # the main path's form: into the interior window of a heat3d block
    # (strided), whose ghosts must keep their values
    block = torch.full((ranks, *local), -7.0, device=dev)
    interior = block[:, 1:-1, 1:-1, :]
    bitwise = {}
    for label, inp, weights in [*cases, ("update f32, strided out", xp, wr)]:
        strided = label.endswith("strided out")
        outk = interior if strided else torch.empty(
            (ranks, *(s - 2 for s in inp.shape[1:])), dtype=inp.dtype, device=dev)
        stencil27(inp, weights, outk)
        want = stencil27_ref(inp, weights)
        torch.cuda.synchronize()
        rtol, atol = STENCIL_TOL[str(inp.dtype)[6:]]
        err = (outk.float() - want.float()).abs().max().item()
        if not torch.isfinite(outk.float()).all() or not torch.allclose(
                outk.float(), want.float(), rtol=rtol, atol=atol):
            fail(f"stencil27 {label} {tuple(inp.shape)}: max abs err {err}")
        bitwise[label] = torch.equal(outk, want)
        if strided:
            outk.fill_(-7.0)
            if not bool((block == -7.0).all()):
                fail("stencil27 strided out: wrote outside the block's interior")
        worst = max(worst, err)
        print(f"stencil27 {label} {tuple(inp.shape)}: max abs err {err} "
              f"(bitwise {bitwise[label]})", flush=True)
        del outk, want
    del cases
    outk = torch.empty((ranks, *(s - 2 for s in xp.shape[1:])), dtype=xp.dtype, device=dev)
    conv_w = wr.view(1, 1, 3, 3, 3)
    xp5 = xp.unsqueeze(1)
    conv = F.conv3d(xp5, conv_w)
    torch.cuda.synchronize()
    conv_err = (conv.view_as(outk) - stencil27_ref(xp, wr)).abs().max().item()
    del conv
    xbf = xp.to(torch.bfloat16)
    outbf = torch.empty_like(outk, dtype=torch.bfloat16)
    kernels["stencil27"] = dict(
        name="stencil27", route="cuda", source="src/repro_torch/kernels/csrc/stencil27.cu",
        replaces="src/repro/kernels/stencil27/stencil27.py:67", max_abs_err=worst,
        ms=time_ms(torch, lambda: stencil27(xp, wr, interior)),
        ms_contiguous_out=time_ms(torch, lambda: stencil27(xp, wr, outk)),
        ms_bf16=time_ms(torch, lambda: stencil27(xbf, wr, outbf)),
        device_ms=device_ms(torch, lambda: stencil27(xp, wr, interior), flush=flush, reps=3),
        plain_ms=time_ms(torch, lambda: stencil27_ref(xp, wr), reps=3),
        bound_ms=bound_ms((xp.numel() + outk.numel()) * 4), bound_by="bytes",
        bound_ms_bf16=bound_ms((xp.numel() + outk.numel()) * 2),
        library_ms=time_ms(torch, lambda: F.conv3d(xp5, conv_w), reps=3),
        library_max_abs_err=conv_err, shape=list(xp.shape), bitwise=bitwise,
        timing="ms: CUDA events around one call into the interior window of a heat3d block "
               "(the main path's strided out); ms_contiguous_out, ms_bf16: the same into a "
               "contiguous out; device_ms: torch.profiler device time of the strided call",
    )
    print("stencil27:", json.dumps(kernels["stencil27"]), flush=True)
    # views keep their base alive: win and xflat hold x's block set, inp
    # the last case's xp (4.36 GB that every later phase would carry)
    del xp, xp5, outk, xbf, outbf, block, interior, x, xb, win, xflat, inp
    torch.cuda.empty_cache()

    lap("2 pack and stencil kernels")
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

    lap("3 exchange matrix")
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
        # run_cycles' warmup + timed, and a plan's eager warm-up at init
        # (one a captured graph: overlap captures one a parity)
        cycles = 3 + HEAT_CYCLES * HEAT_REPEATS + {"standard": 0, "overlap": 2}.get(name, 1)
        per_cycle[name] = {k: (v - before.get(k, 0)) / cycles for k, v in _build.LAUNCHES.items()}
        results[label] = r
        print(f"heat3d {label}: us_per_cycle={r.us_per_cycle:.1f} init_us={r.init_us:.1f} "
              f"collective_count={r.collective_count} launches/cycle={per_cycle[name]} "
              f"checksum={r.checksum!r} device={r.device}", flush=True)
    launches = dict(_build.LAUNCHES)
    print("launches on the heat3d path:", json.dumps(launches), flush=True)
    for kname in ("copy_convert", "gather_pack", "stencil27"):
        if launches.get(kname, 0) <= 0:
            fail(f"kernel {kname} was not launched on the main path")
        add_launches(kernels[kname], "heat3d (phase 4)", launches[kname])
    ref_sum = next(iter(results.values())).checksum
    for label, r in results.items():
        if not math.isfinite(r.checksum) or abs(r.checksum - ref_sum) >= 1e-3 + 1e-3 * abs(ref_sum):
            fail(f"heat3d {label} checksum {r.checksum} diverged from {ref_sum}")

    # the same cycles through packer `slice` and the plain stencil
    plain = make_driver(StrategyConfig(name="persistent", packer="slice"), mesh, dom.halo_spec,
                        ndim=3, update_fn=heat3d_update(weights, dev, stencil=stencil27_ref))
    x2 = dom.random(2)
    ref_x = x2.clone()
    for _ in range(VERIFY_CYCLES):
        ref_x = plain.step(ref_x)
    ref_x = plain.wait(ref_x)
    plain.free()
    rtol, atol = STENCIL_TOL["float32"]
    breakdown, plan_timing = {}, {}
    for name in strategies:
        drv = make_driver(StrategyConfig(name=name, packer="cuda", n_parts=4 if name == "partitioned" else 1),
                          mesh, dom.halo_spec, ndim=3, update_fn=update)
        y = x2.clone()
        for _ in range(VERIFY_CYCLES):
            y = drv.step(y)
        y = drv.wait(y)
        if not torch.isfinite(y).all() or not torch.allclose(y, ref_x, rtol=rtol, atol=atol):
            fail(f"heat3d {name}: {VERIFY_CYCLES} cycles differ from the slice + stencil27_ref cycles "
                 f"(max abs err {(y - ref_x).abs().max().item()})")
        print(f"heat3d {name}: {VERIFY_CYCLES} cycles match slice + stencil27_ref "
              f"(max abs err {(y - ref_x).abs().max().item()})", flush=True)
        if name == "standard":  # no plan: eager, the baseline's dispatch path
            b = breakdown[name] = device_breakdown(drv, y)
        else:
            # the captured plan's replays against its eager step, bitwise
            if not drv.plan.captured:
                fail(f"heat3d {name}: the plan on the card holds no CUDA graph")
            got = y.clone()  # overlap's eager step writes the plan's buffers
            e = x2.clone()
            for _ in range(VERIFY_CYCLES):
                e = drv.plan.fn(e)
            torch.cuda.synchronize()
            if not torch.equal(got, e):
                fail(f"heat3d {name}: {VERIFY_CYCLES} graph cycles differ from the eager ones "
                     f"(max abs err {(got - e).abs().max().item()})")
            del got, e
            # host time a cycle (20-cycle windows, eager and graph in turns)
            # and where the cycle's time goes (torch.profiler, 3 cycles each)
            t = plan_timing[name] = eager_vs_graph(*driver_steps(drv, y), n=HEAT_CYCLES)
            b = breakdown[name] = t["graph"].pop("breakdown")
            eb = t["eager"].pop("breakdown")
            print(f"heat3d {name}: {VERIFY_CYCLES} graph cycles bitwise-equal to plan.fn's; "
                  f"us_per_cycle eager {t['eager']['us']:.1f} (idle {t['eager']['idle_share']:.3f},"
                  f" by host clock {t['eager']['idle_share_host']:.3f}, "
                  f"{eb['busy_us_per_cycle']:.0f} us busy) / graph {t['graph']['us']:.1f} (idle "
                  f"{t['graph']['idle_share']:.3f}, by host clock "
                  f"{t['graph']['idle_share_host']:.3f}, {b['busy_us_per_cycle']:.0f} us busy), spread "
                  f"{t['eager']['spread']:.3f} / {t['graph']['spread']:.3f}; init_us with the "
                  f"capture {drv.plan.init_seconds * 1e6:.0f}", flush=True)
            t["init_us"] = drv.plan.init_seconds * 1e6
        drv.free()
        del y
        top = ", ".join(f"{short_kernel_name(k['name'])} x{k['launches_per_cycle']:g} "
                        f"{k['us_per_cycle']:.0f}us"
                        for k in b["kernels"][:6])
        # the stencil writes the block's interior itself: no copy back
        # (the overlap schedule still copies its pieces in and out)
        copies = [k for k in b["kernels"] if short_kernel_name(k["name"]) == "direct_copy"]
        b["direct_copy_us_per_cycle"] = sum(k["us_per_cycle"] for k in copies)
        print(f"heat3d {name} breakdown: window {b['window_us_per_cycle']:.0f} us/cycle, "
              f"device busy {b['busy_us_per_cycle']:.0f} us, idle share {b['idle_share']:.3f}; "
              f"{top}; direct_copy {sum(k['launches_per_cycle'] for k in copies):g} a cycle, "
              f"{b['direct_copy_us_per_cycle']:.0f} us", flush=True)

    lap("4 heat3d")
    # -- A. flash_attention against its plain version ------------------------
    del drv, plain, ref_x, x2, interior, weights, update, dom, mesh
    torch.cuda.empty_cache()
    from repro_torch.kernels.costs import flash_cost
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    gen = torch.Generator(dev).manual_seed(7)

    def qkv(b, s, hq, hkv, d, dtype, strided=False, skv=None):
        skv = s if skv is None else skv
        q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
        k, v = (torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        return (q if strided else q.contiguous()), k, v

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"llama3-8b prefill S={s}", (1, s, 32, 8, 128), bf16, True, False, None)
             for s in (8, 128, 1000, 2048)]
    cases += [("MHA d=64 causal", (1, 512, 32, 32, 64), bf16, True, False, None),
              ("MHA d=64 non-causal", (1, 512, 32, 32, 64), bf16, False, False, None),
              ("GQA f32 causal (CUDA-core route)", (1, 256, 32, 8, 128), f32, True, False, None),
              ("strided q, ragged, non-causal", (2, 100, 4, 2, 64), bf16, False, True, None),
              ("Sq > Skv causal: rows past Skv see every key", (1, 1000, 32, 8, 128), bf16, True,
               False, 300),
              ("Sq != Skv non-causal, ragged", (2, 200, 32, 8, 128), bf16, False, False, 777)]
    worst = 0.0
    for label, shape, dtype, causal, strided, skv in cases:
        q, k, v = qkv(*shape, dtype, strided, skv)
        got = flash_attention(q, k, v, causal=causal)
        want = attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dtype)[6:]]
        err = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got.float()).all() or not torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"flash_attention {label} q {tuple(q.shape)} {dtype}: max abs err {err}")
        worst = max(worst, err)
        print(f"flash_attention {label} q {tuple(q.shape)} kv {tuple(k.shape)} {str(dtype)[6:]}: "
              f"max abs err {err} (tol {tol})", flush=True)
    q, k, v = qkv(1, 2048, 32, 8, 128, bf16)
    got = flash_attention(q, k, v, causal=True).float()
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want = attention_plain(q32, k32, v32, causal=True)
    fault = attention_keys_dropped(torch, q32, k32, v32, FLASH_FAULT_KEYS)
    late = q.shape[1] // 2

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    rel_norm = {"all rows": rel(got, want), "late half": rel(got[:, late:], want[:, late:]),
                "fault, all rows": rel(fault, want),
                "fault, late half": rel(fault[:, late:], want[:, late:])}
    print(f"flash_attention S=2048 relative-norm error vs plain f32 (tol {FLASH_REL_TOL}; "
          f"fault: keys {FLASH_FAULT_KEYS[0]}-{FLASH_FAULT_KEYS[1] - 1} dropped): "
          f"{json.dumps(rel_norm)}", flush=True)
    if not (rel_norm["all rows"] < FLASH_REL_TOL and rel_norm["late half"] < FLASH_REL_TOL):
        fail(f"flash_attention S=2048: relative-norm error {rel_norm}")
    if not min(rel_norm["fault, all rows"], rel_norm["fault, late half"]) > FLASH_REL_TOL:
        fail(f"flash_attention S=2048: the relative-norm check cannot see a skipped kv tile "
             f"{rel_norm}")
    del q32, k32, v32, fault
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    torch.cuda.synchronize()
    sdpa_err = (sdpa.transpose(1, 2).float() - attention_plain(q, k, v).float()).abs().max().item()
    flops, nbytes = flash_cost(q.shape[0], q.shape[1], q.shape[2], k.shape[1], k.shape[2],
                               q.shape[3], causal=True, itemsize=q.element_size())

    def kernel():
        return flash_attention(q, k, v, causal=True)

    def sdpa_call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        route_by_dtype={"bfloat16": "tensor cores: wgmma bf16, TMA loads (flash_tc_kernel)",
                        "float32": "CUDA cores: f32 FMA (flash_kernel)"},
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash.py:127", max_abs_err=worst,
        ms=time_ms_batched(torch, kernel), ms_single=time_ms(torch, kernel),
        plain_ms=time_ms(torch, lambda: attention_plain(q, k, v, causal=True)),
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOP_PER_S > nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=time_ms_batched(torch, sdpa_call), library_ms_single=time_ms(torch, sdpa_call),
        timing="ms, library_ms: 20 back-to-back launches between one pair of CUDA events / 20 "
               "(median of 5); *_single: one launch (median of 7)",
        library_max_abs_err=sdpa_err, rel_norm_err=rel_norm, flops=flops, flop_convention="2*B*Hq*Sq*Skv*D (causal)",
        bytes=nbytes, shape=[list(q.shape), list(k.shape)],
    )
    del q, k, v, qt, kt, vt, sdpa, got, want
    torch.cuda.empty_cache()

    # the last families' shapes: hubert's encoder (head dim 80, the padded
    # tensor-core route), llama-3.2-vision's cross attention, zamba2's
    # shared block
    fam_cases = [("hubert-xlarge encoder, D=80, non-causal", (4, 1000, 16, 16, 80), bf16, False,
                  None),
                 ("hubert-xlarge encoder, D=80, non-causal (CUDA-core route)",
                  (4, 1000, 16, 16, 80), f32, False, None),
                 ("llama-3.2-vision cross attention, 512 queries on 1601 vision tokens",
                  (1, 512, 32, 8, 128), bf16, False, 1601),
                 ("zamba2-1.2b shared block, causal", (1, 2048, 32, 32, 64), bf16, True, None)]
    for label, shape, dtype, causal, skv in fam_cases:
        q, k, v = qkv(*shape, dtype, False, skv)
        got = flash_attention(q, k, v, causal=causal)
        want = attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dtype)[6:]]
        err = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got.float()).all() or not torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"flash_attention {label} q {tuple(q.shape)} {dtype}: max abs err {err}")
        worst = max(worst, err)
        print(f"flash_attention {label} q {tuple(q.shape)} kv {tuple(k.shape)} {str(dtype)[6:]}: "
              f"max abs err {err} (tol {tol})", flush=True)
    kernels["flash_attention"]["max_abs_err"] = worst
    q, k, v = qkv(4, 1000, 16, 16, 80, bf16)
    got = flash_attention(q, k, v, causal=False).float()
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want = attention_plain(q32, k32, v32, causal=False)
    fault = attention_keys_dropped(torch, q32, k32, v32, FLASH_FAULT_KEYS_D80, causal=False)
    rel80 = {"all rows": rel(got, want), "fault": rel(fault, want)}
    print(f"flash_attention D=80 relative-norm error vs plain f32 (tol {FLASH_REL_TOL}; fault: "
          f"keys {FLASH_FAULT_KEYS_D80[0]}-{FLASH_FAULT_KEYS_D80[1] - 1} dropped): "
          f"{json.dumps(rel80)}", flush=True)
    if not rel80["all rows"] < FLASH_REL_TOL:
        fail(f"flash_attention D=80: relative-norm error {rel80}")
    if not rel80["fault"] > FLASH_REL_TOL:
        fail(f"flash_attention D=80: the relative-norm check cannot see a skipped kv tile {rel80}")
    del q32, k32, v32, fault, got, want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops, nbytes = flash_cost(q.shape[0], q.shape[1], q.shape[2], k.shape[1], k.shape[2],
                               q.shape[3], causal=False, itemsize=q.element_size())

    def kernel80():
        return flash_attention(q, k, v, causal=False)

    def sdpa80():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=False)

    sdpa_err = (sdpa80().transpose(1, 2).float()
                - attention_plain(q, k, v, causal=False).float()).abs().max().item()
    kernels["flash_attention"]["d80"] = dict(
        shape=[list(q.shape), list(k.shape)], causal=False, ms=time_ms_batched(torch, kernel80),
        ms_single=time_ms(torch, kernel80),
        plain_ms=time_ms(torch, lambda: attention_plain(q, k, v, causal=False)),
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOP_PER_S > nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=time_ms_batched(torch, sdpa80), library_ms_single=time_ms(torch, sdpa80),
        library_max_abs_err=sdpa_err, rel_norm_err=rel80, flops=flops,
        flop_convention="4*B*Hq*Sq*Skv*D (non-causal)", bytes=nbytes,
        timing="as the flash entry's: ms, library_ms 20 back-to-back launches / 20; *_single one")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    # head dims 16 and 32: the reduced configs' and the examples', on the
    # 64-wide tile zero-filled past D
    import flash_head_dims

    try:
        small_d = flash_head_dims.head_dim_phase(torch, dev)
    except RuntimeError as e:
        fail(f"phase A, head dims 16 and 32: {e}")
    kernels["flash_attention"]["max_abs_err"] = max(worst, small_d["checks"]["fwd_max_abs_err"])
    small_bwd = {}
    for d in flash_head_dims.HEAD_DIMS:
        rows = {tag: small_d["timed"][f"d{d}_{tag}"] for tag in ("path", "long")}
        kernels["flash_attention"][f"d{d}"] = {
            tag: dict(shape=row["shape"], causal=True, **row["forward"])
            for tag, row in rows.items()}
        small_bwd[f"d{d}"] = {tag: dict(shape=row["shape"], causal=True, **row["backward"])
                              for tag, row in rows.items()}
    record["flash_head_dims"] = small_d
    print("flash_attention:", json.dumps(kernels["flash_attention"]), flush=True)
    torch.cuda.empty_cache()

    lap("A")
    # -- P. the examples at their defaults ------------------------------------
    record["examples"] = examples(torch, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()

    lap("P")
    # -- B. serving llama3-8b at full width: the second main path ------------
    record["serving"] = serve_llama(torch, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()  # the llama3-8b weights go before phase D

    lap("B with H1-H2")
    # -- C. wkv_chunked against its plain version ----------------------------
    check_wkv(torch, dev, kernels)
    torch.cuda.empty_cache()

    lap("C")
    # -- D. serving rwkv6-1.6b at full width: the third main path ------------
    record["rwkv_serving"] = serve_rwkv(torch, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()  # the rwkv6 weights go before phase I

    lap("D with H3")
    # -- I. the MoE model: phi3.5-moe served and expert-parallel, grok-1 -------
    record["moe"] = serve_moe(torch, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()  # the phi and grok weights go before phase J

    lap("I")
    # -- J. the LM serve bench and the collective count -------------------------
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record["serve_bench"] = serve_bench(torch, dev, kernels, out_dir)
    gc.collect()
    torch.cuda.empty_cache()

    lap("J")
    # -- K. the last model families: zamba2, llama-3.2-vision, hubert -----------
    record["families"] = families(torch, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()

    lap("K")
    # -- E. the §VI sweep on the card: smoke grid, card grid, auto ------------
    record["sweep"] = sweep_phase(torch, dev, out_dir)
    torch.cuda.empty_cache()

    lap("E")
    # -- F. the process axis: a 2-process grid on the card -------------------
    record["grid"] = grid_phase(torch, dev, out_dir)
    torch.cuda.empty_cache()

    lap("F")
    # -- G. elastic recovery at the heat3d size ---------------------------------
    record["elastic"] = elastic_phase(torch, dev, out_dir)
    gc.collect()
    torch.cuda.empty_cache()

    lap("G")
    # -- L. training: the flash backward, stablelm-1.6b at full width -----------
    record["training"] = training(torch, dev, kernels)
    kernels["flash_attention_bwd"].update(small_bwd)
    add_launches(kernels["flash_attention_bwd"], "P", record["examples"]["launches_bwd"])
    kernels["flash_attention_bwd"]["bwd_rel_l2_d16_d32"] = (
        small_d["checks"]["bwd_max_rel_l2"])
    gc.collect()
    torch.cuda.empty_cache()

    lap("L")
    # -- M. every family trains: the WKV backward, rwkv6-1.6b, the others --------
    record["families_training"] = families_training(torch, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()

    lap("M")
    # -- N. training on a mesh of stacked ranks, restarted onto a smaller one ----
    record["mesh_training"] = mesh_training(torch, dev, kernels, record["training"]["L2"])
    gc.collect()
    torch.cuda.empty_cache()

    lap("N")
    # -- O. the dry-run against the card: meta routes, a production cell, L2 ----
    record["dryrun"] = dryrun_check(torch, dev, record["training"]["L2"])

    lap("O")
    # -- 5. results -----------------------------------------------------------
    record.update(
        kernels=list(kernels.values()),
        heat3d={label: r.record() for label, r in results.items()},
        launches_per_cycle=per_cycle, exchange_cells=cells, breakdown=breakdown,
        heat3d_plan_timing=plan_timing, random_s=random_s,
    )
    # every device breakdown of this process: the sessions it took (1: traced
    # once; more: a session lost device records and was traced again), the
    # launch calls its session kept beyond its device records, and its clock
    # check
    from repro_torch.core.profiling import TRACES

    gaps = [t[k] for t in TRACES for k in ("first_launch_to_device_us",
                                           "last_device_to_sync_end_us") if t.get(k) is not None]
    record["profiler_traces"] = dict(calls=len(TRACES), retraced=sum(t["sessions"] > 1
                                                                     for t in TRACES),
                                     missing_records=sum(t.get("missing_records", 0)
                                                         for t in TRACES),
                                     min_gap_us=min(gaps, default=None),
                                     max_gap_us=max(gaps, default=None), traces=TRACES)
    print(f"profiler: {len(TRACES)} device breakdowns in this process, "
          f"{record['profiler_traces']['retraced']} of them traced again (sessions "
          f"{[t['sessions'] for t in TRACES]}), {record['profiler_traces']['missing_records']} "
          f"launch calls without a device record in the sessions kept; clock-check gaps "
          f"{record['profiler_traces']['min_gap_us']} to {record['profiler_traces']['max_gap_us']} us",
          flush=True)
    record["phase_s"] = phase_s
    record["phase_allocated"] = phase_allocated
    record["script_s"] = time.perf_counter() - t_main
    print(f"chip_smoke: all phases in {record['script_s']:.1f} s", flush=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kd[k] for k in (*keys, "launches_by_path", "route_by_dtype",
                                                      "d80", "d16", "d32")
                                   if k in kd}
                                  for kd in kernels.values()]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid-worker"]:
        sys.exit(grid_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--elastic-worker"]:
        sys.exit(elastic_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
