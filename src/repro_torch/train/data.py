"""Data pipeline: synthetic and byte-level text batches, deterministic
resume.

Both sources are stateless functions of ``(seed, step)`` with an explicit
cursor (:class:`DataState`) that every checkpoint saves, so a restore
replays the exact stream.  :class:`ByteTextLM` is numpy and yields the
reference's batches token for token; :class:`SyntheticLM` draws from a
``torch.Generator`` (its tokens differ from the reference's
``jax.random`` ones).  The image source waits for ROADMAP item A13f.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

_DEFAULT_CORPUS = (
    "low rank decomposition replaces a weight matrix with two smaller "
    "factors computed from its singular value decomposition. the ranks "
    "are chosen for a target compression ratio, then aligned to hardware "
    "tiles so the matrix units stay full. freezing the teacher derived "
    "factors accelerates fine tuning, merging factors into neighbouring "
    "layers restores the original depth, and branching splits the core "
    "into parallel groups that run as one grouped matmul. " * 50
)


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_dict(self) -> dict:
        return {"step": np.asarray(self.step)}

    @staticmethod
    def from_dict(d: dict) -> "DataState":
        return DataState(step=int(np.asarray(d["step"])))


class SyntheticLM:
    """Random-token batches: ``batch(i)`` is a pure function of (seed, i),
    drawn on the CPU."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed

    def batch(self, step: int) -> dict:
        from repro_torch.models.api import synth_inputs
        g = torch.Generator().manual_seed((self.seed << 32) + step)
        return synth_inputs(self.cfg, self.shape, g)

    def stream(self, state: DataState) -> Iterator[tuple[dict, DataState]]:
        step = state.step
        while True:
            yield self.batch(step), DataState(step + 1)
            step += 1


class ByteTextLM:
    """Byte-level LM batches from a text file (or a built-in corpus).

    Deterministic shuffle per epoch via a seed-derived permutation; the
    step cursor alone reconstructs the position, so resume is exact.
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 path: str | None = None, seed: int = 0):
        if path and os.path.isfile(path):
            with open(path, "rb") as f:
                raw = f.read()
        else:
            raw = _DEFAULT_CORPUS.encode()
        data = np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
        data = data % cfg.vocab_size
        self.tokens = data
        self.batch_size = batch
        self.seq_len = seq_len
        self.seed = seed
        n = (len(data) - 1) // seq_len
        if n < 1:
            raise ValueError("corpus shorter than one sequence")
        self.n_seqs = n

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(
            int.from_bytes(hashlib.sha256(
                f"{self.seed}:{epoch}".encode()).digest()[:8], "little"))
        return rng.permutation(self.n_seqs)

    def batch(self, step: int) -> dict:
        """``{"tokens": (batch, seq_len) int32}`` as a numpy array."""
        per_epoch = max(1, self.n_seqs // self.batch_size)
        epoch, idx = divmod(step, per_epoch)
        perm = self._perm(epoch)
        rows = []
        for b in range(self.batch_size):
            sid = perm[(idx * self.batch_size + b) % self.n_seqs]
            lo = sid * self.seq_len
            rows.append(self.tokens[lo:lo + self.seq_len])
        return {"tokens": np.stack(rows)}

    def stream(self, state: DataState) -> Iterator[tuple[dict, DataState]]:
        step = state.step
        while True:
            yield self.batch(step), DataState(step + 1)
            step += 1
