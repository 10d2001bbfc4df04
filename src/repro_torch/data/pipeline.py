"""Deterministic synthetic data pipeline with host-side prefetch (PyTorch
port of ``src/repro/data/pipeline.py``).

Tokens follow a Zipf-like distribution drawn by numpy from a per-(seed,
step) stream, so a restarted run consumes byte-identical batches, and
:meth:`SyntheticLM.batch_at` gives the JAX package's batches byte for byte.
A background thread keeps ``depth`` batches ahead of the training loop as
pinned CPU tensors; the copy to the card (``non_blocking``) is made by the
consuming thread, on its current stream, so no CUDA work runs on the
background thread.

Multi-host note: each process draws only its slice of the global batch
(:meth:`SyntheticLM.host_slice`), by the process count and index of the
port's mesh, else of ``torch.distributed`` when it is initialized.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic LM/audio/vlm batches for a config."""

    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0xC0FFEE]))
        b, s, v = self.global_batch, self.seq_len, self.cfg.vocab_size
        if self.cfg.family == "audio":
            frames = rng.normal(size=(b, s, self.cfg.d_vision)).astype(np.float32)
            labels = self._zipf(rng, (b, s), v)
            mask = (rng.random((b, s)) < 0.3).astype(np.float32)
            return {"frames": frames, "labels": labels, "mask": mask}
        # zipf-ish heavy-tailed token stream + next-token labels
        tokens = self._zipf(rng, (b, s + 1), v)
        out = {"tokens": tokens[:, :-1].astype(np.int32),
               "labels": tokens[:, 1:].astype(np.int32)}
        if self.cfg.family == "vlm":
            out["vision_emb"] = rng.normal(
                size=(b, self.cfg.vision_tokens, self.cfg.d_vision)
            ).astype(np.float32)
        return out

    @staticmethod
    def _zipf(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
        u = rng.random(shape)
        # inverse-CDF of a truncated zipf(1.1): heavy-tailed like real text
        ranks = np.floor(np.exp(u * np.log(vocab))).astype(np.int64) - 1
        return np.clip(ranks, 0, vocab - 1).astype(np.int32)

    @staticmethod
    def host_slice(batch: dict[str, np.ndarray], mesh: Any = None) -> dict[str, np.ndarray]:
        """This process's rows of a global batch: ``mesh.processes`` and
        ``mesh.process_index`` of a :class:`~repro_torch.core.mesh.
        VirtualMesh`, else ``torch.distributed``'s world size and rank when
        it is initialized, else every row."""
        if mesh is not None:
            n, i = mesh.processes, mesh.process_index
        elif torch.distributed.is_available() and torch.distributed.is_initialized():
            n, i = torch.distributed.get_world_size(), torch.distributed.get_rank()
        else:
            n, i = 1, 0
        if n == 1:
            return batch
        return {k: v[i * v.shape[0] // n: (i + 1) * v.shape[0] // n] for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of pinned host batches; iterating yields
    ``(step, batch)`` with the batch's tensors on ``device`` (copied by the
    caller's thread, ``non_blocking``, on its current stream)."""

    def __init__(self, dataset: SyntheticLM, device: str | torch.device = "cpu",
                 start_step: int = 0, depth: int = 2):
        self.dataset = dataset
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _host(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        pin = self.device.type == "cuda"
        out = {}
        for k, v in SyntheticLM.host_slice(batch).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if pin else t
        return out

    def _work(self) -> None:
        step, batch = self._step, None
        while not self._stop.is_set():
            if batch is None:
                batch = self._host(self.dataset.batch_at(step))
            try:
                self._q.put((step, batch), timeout=0.5)
            except queue.Full:
                continue
            step, batch = step + 1, None

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        step, batch = self._q.get()
        return step, {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
