"""Batched serving engine with continuous batching and persistent step plans
(PyTorch port of ``src/repro/serving/engine.py``).

Slots hold independent requests; prefill fills a slot's cache region,
decode advances every active slot one token per step.  Both steps run
through a :class:`~repro_torch.core.plan.PlanCache` keyed by function
identity and abstract arguments, as in the JAX engine, so ``plan_inits``
and ``plan_hits`` count the same things.  A plan's step closes over the
weights.  On the card the decode plan captures its step as a CUDA graph at
the first decode (static inputs: the ``(max_slots, 1)`` tokens and the
batched cache) and every later step replays it; prefill plans run eagerly
(one prefill a request, mostly device-busy, and a graph pool a bucket
would hold a full activation set).  When a slot finishes (EOS / max
tokens), the next queued request takes it over without stalling the
running batch (continuous batching).

Under a sequence-parallel ``ctx`` (a :class:`~repro_torch.core.mesh.
VirtualMesh` with ``seq_parallel=True``) a dense prefill runs ring
attention over the model axis; a bucket the ring size does not divide is
refused with ``ValueError``, as JAX's ``shard_map`` refuses it.  Under
``moe_mode="ep"`` a MoE prefill dispatches its tokens to the experts over
the model axis, and a prompt the axis does not divide is refused the same
way.  Decode runs as without the context (the MoE decode step is the
dropless one).  A VLM request carries no image: its prefill gets zero
patch embeddings, as in the JAX engine.  An encoder-only model is
refused.

The decode batch is fixed-size: empty slots decode padding tokens whose
outputs are ignored.  The engine's cache lives on the model's device and is
updated in place: a decode step writes its new state back into the cache
it was given, so after the first decode the engine holds the decode plan's
static cache, and a prefill's slot write lands in the graph's inputs.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core.plan import PlanCache
from repro_torch.models.api import Model
from repro_torch.parallel.context import LOCAL, ParallelContext


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never stops early
    tokens_out: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    tokens_generated: int = 0
    plan_inits: int = 0
    plan_hits: int = 0


class ServingEngine:
    def __init__(self, model: Model, params: Any, *, max_slots: int = 4,
                 max_len: int = 256, ctx: ParallelContext = LOCAL):
        if not model.has_decode:
            raise ValueError(f"{model.cfg.name} is encoder-only")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_slots = max_slots
        self.max_len = max_len
        self.ctx = ctx
        self.plans = PlanCache()
        self.stats = EngineStats()
        self._queue: deque[Request] = deque()
        self._slots: list[Request | None] = [None] * max_slots
        # one shared batched cache; per-slot position bookkeeping
        self._cache = model.init_cache(max_slots, max_len)
        self._positions = np.zeros(max_slots, np.int64)
        self._uid = 0
        # per-entry batch (slot) axis of the cache: the axis whose extent
        # tracks the cache batch size, from shapes alone (the meta device
        # allocates nothing; JAX uses eval_shape).  Comparing batch 1 with
        # batch 2 keeps max_slots == 1 from matching every size-1 axis.
        s1 = model.init_cache(1, max_len, device="meta")
        s2 = model.init_cache(2, max_len, device="meta")
        self._slot_axes = {
            name: next((ax for ax, (x, y) in enumerate(zip(s1[name].shape, s2[name].shape))
                        if x != y), None)
            for name in s1
        }
        # the wire knobs are invisible to shapes, so stamp them into every
        # plan key: packer/coalesce/n_parts/moe_comm changes must miss
        self._comm_key = ("comm", ctx.comm_packer, ctx.comm_coalesce,
                          ctx.n_parts, ctx.moe_comm)

        # the step closures are created once: the plan key includes the
        # function identity, so a fresh closure per call would defeat the
        # cache and init a plan for every request
        def decode_fn(params, token, cache):
            logits, new = model.decode_step(params, token, cache, ctx=ctx)
            return logits, _carry(cache, new)

        def prefill_fn(params, batch, cache):
            return model.prefill(params, batch, cache, ctx=ctx)

        def prefill_bucketed_fn(params, batch, cache, true_len):
            return model.prefill(params, batch, cache, ctx=ctx, true_len=true_len)

        self._decode_fn = decode_fn
        self._prefill_fn = prefill_fn
        self._prefill_bucketed_fn = prefill_bucketed_fn

    # -- public API ---------------------------------------------------------
    def submit(self, prompt: list[int] | np.ndarray, max_new_tokens: int = 16,
               eos_id: int = -1) -> int:
        req = Request(self._uid, np.asarray(prompt, np.int32), max_new_tokens, eos_id)
        self._uid += 1
        self._queue.append(req)
        return req.uid

    def run(self) -> dict[int, list[int]]:
        """Serve until queue and slots drain; returns uid -> generated tokens."""
        finished: dict[int, list[int]] = {}
        while self._queue or any(s is not None for s in self._slots):
            self._fill_slots(finished)
            self._decode_once(finished)
        return finished

    # -- internals ------------------------------------------------------------
    def _plan(self, fn, args, *, example_args=None):
        """The plan of ``fn`` on ``args`` (weights first); its step closes
        over the weights, so ``start`` takes ``args[1:]``.  With
        ``example_args`` a plan on the card captures its step on them."""
        key = self.plans.key_for(fn, args, self._comm_key)
        return self.plans.get_or_init(lambda: functools.partial(fn, args[0]), key=key,
                                      device=self.device, example_args=example_args,
                                      name=fn.__name__)

    def _fill_slots(self, finished: dict[int, list[int]]) -> None:
        for i, slot in enumerate(self._slots):
            if slot is not None:
                continue
            # a request can finish AT prefill (max_new_tokens <= 1, or the
            # first sampled token is EOS): it never occupies a decode slot,
            # and the freed slot immediately takes the next queued request.
            while self._queue:
                req = self._queue.popleft()
                self._prefill_slot(i, req)
                if req.max_new_tokens <= 1 or req.tokens_out[-1] == req.eos_id:
                    req.done = True
                    finished[req.uid] = req.tokens_out[: req.max_new_tokens]
                    continue
                self._slots[i] = req
                break

    def _prefill_bucket(self, plen: int) -> int | None:
        """Padded prompt length, or None for exact-length prefill.

        Only the dense transformer prefills bucketed, as in the JAX engine:
        the other families are length-sensitive (RWKV's and the hybrid's
        recurrent states would run on through the padding, MoE capacity
        routing would count the padding's tokens, the VLM's prefill has no
        bucketed form), so they prefill at the exact length, one plan per
        distinct length.
        """
        if self.model.cfg.family != "dense":
            return None
        return min(_next_pow2(plen), self.max_len)

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Single-slot prefill into the shared batched cache: a batch-1
        cache is filled, then copied into the batched cache at ``slot``.
        Dense prompts right-pad to power-of-two buckets with the true length
        as a tensor argument, so every length in a bucket shares one plan;
        other families prefill at the exact length."""
        prompt = np.asarray(req.prompt, np.int64)[None]
        plen = prompt.shape[1]
        bucket = self._prefill_bucket(plen)
        cache1 = self.model.init_cache(1, self.max_len)
        batch = {"tokens": torch.as_tensor(prompt, device=self.device)}
        cfg = self.model.cfg
        if cfg.family == "vlm":  # no image: zero patch embeddings, as the JAX engine
            batch["vision_emb"] = torch.zeros((1, cfg.vision_tokens, cfg.d_vision),
                                              dtype=torch.bfloat16, device=self.device)
        if bucket is None:
            fn = self._prefill_fn
            args = (self.params, batch, cache1)
        else:
            padded = np.pad(prompt, ((0, 0), (0, bucket - plen)))
            true_len = torch.full((1,), plen, dtype=torch.int32, device=self.device)
            fn = self._prefill_bucketed_fn
            args = (self.params, {**batch, "tokens": torch.as_tensor(padded, device=self.device)},
                    cache1, true_len)
        logits, cache1 = self._plan(fn, args).start(*args[1:])
        self.stats.prefills += 1
        self._cache = _write_slot(self._cache, cache1, slot, self._slot_axes)
        self._positions[slot] = plen
        req.tokens_out.append(int(logits[0, -1].float().argmax()))

    def _decode_once(self, finished: dict[int, list[int]]) -> None:
        if not any(s is not None for s in self._slots):
            return
        tokens = np.zeros((self.max_slots, 1), np.int64)
        for i, req in enumerate(self._slots):
            if req is not None:
                tokens[i, 0] = req.tokens_out[-1]
        # shared cache decode: cache["pos"] is (B,) per slot, written at
        # prefill time (continuous batching needs no uniform position)
        args = (self.params, torch.as_tensor(tokens, device=self.device), self._cache)
        plan = self._plan(self._decode_fn, args, example_args=args[1:])
        logits, self._cache = plan.start(*args[1:])
        self.stats.decode_steps += 1
        # outside the graph: the step's one synchronization
        nxt_all = logits[:, 0].float().argmax(dim=-1).tolist()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            nxt = nxt_all[i]
            req.tokens_out.append(nxt)
            self.stats.tokens_generated += 1
            self._positions[i] += 1
            # >=, counting the prefill token: max_new_tokens=N runs exactly
            # N-1 decode steps for N sampled tokens
            if (len(req.tokens_out) >= req.max_new_tokens
                    or nxt == req.eos_id
                    or self._positions[i] >= self.max_len - 1):
                req.done = True
                finished[req.uid] = req.tokens_out
                self._slots[i] = None
        self.stats.plan_inits = self.plans.stats.inits
        self.stats.plan_hits = self.plans.stats.cache_hits


def _next_pow2(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


def _carry(cache: dict, new: dict) -> dict:
    """Write the entries of a decode step's returned cache ``new`` that are
    fresh tensors (the dense model's ``pos + 1``, the RWKV state) back into
    ``cache`` in place, and return ``cache``: a captured decode step's
    outputs are then its own static inputs, and entries already updated in
    place (the dense K/V cache) are never copied."""
    for name, t in new.items():
        if t is not cache[name]:
            cache[name].copy_(t)
    return cache


def _write_slot(batched_cache: dict, cache1: dict, slot: int, slot_axes: dict) -> dict:
    """Copy a batch-1 cache into row ``slot`` of the batched cache, in
    place.  ``slot_axes`` carries each entry's batch axis; entries with no
    batch axis are slot-independent and stay as they are."""
    for name, axis in slot_axes.items():
        if axis is not None:
            dst = batched_cache[name]
            dst.select(axis, slot).copy_(cache1[name].select(axis, 0))
    return batched_cache
