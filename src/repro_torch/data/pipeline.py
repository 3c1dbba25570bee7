"""Deterministic synthetic LM data: the port's copy of
``repro.data.pipeline`` (numpy, as the reference's host side is), so
that a ``(seed, step)`` gives the reference's tokens bit for bit.

The batch is a function of ``(seed, step)`` alone: a restarted or resumed
run replays the same batches.  The token stream is a per-sequence Markov
chain with 15 % noise, so the LM loss falls during training.
``device_batch`` puts one step's batch on one device; ``sharded_batch``
lays it out over a mesh, each rank taking its block of the host batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..convert import resolve_device
from ..models.config import ArchConfig
from ..parallel.sharding import NamedSharding, place


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frames_dim: int = 0      # >0: also emit (B, S, frames_dim) embeddings


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed Markov transition ridge: next = (tok * a + b) % V with noise
        self._a = int(rng.integers(3, 97)) * 2 + 1
        self._b = int(rng.integers(1, cfg.vocab_size))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """``tokens`` and ``labels`` (B, S) int32, labels the tokens shifted
        by one; ``frames`` (B, S, frames_dim) fp32 where configured."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, S))
        rand = rng.integers(0, V, (B, S))
        for t in range(S):
            nxt = (toks[:, t] * self._a + self._b) % V
            toks[:, t + 1] = np.where(noise[:, t] < 0.15, rand[:, t], nxt)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frames_dim:
            out["frames"] = rng.standard_normal(
                (B, S, cfg.frames_dim)).astype(np.float32)
        return out

    def device_batch(self, step: int,
                     device: str | torch.device | None = None
                     ) -> dict[str, torch.Tensor]:
        """``batch(step)`` on ``device`` (None: the CUDA card): tokens and
        labels as int64, frames fp32."""
        dev = resolve_device(device)
        return {k: _host(k, v).to(dev) for k, v in self.batch(step).items()}

    def sharded_batch(self, step: int,
                      shardings: dict[str, NamedSharding]
                      ) -> dict[str, torch.Tensor]:
        """``batch(step)`` laid out by ``shardings`` (name -> sharding of
        the mesh): each rank moves its own block to the mesh's device,
        as DTensors (dtypes as ``device_batch``'s)."""
        return {k: place(_host(k, v), shardings[k],
                         shardings[k].mesh.device_type)
                for k, v in self.batch(step).items()}


def _host(name: str, arr: np.ndarray) -> torch.Tensor:
    """One batch array as a host tensor: tokens and labels int64, frames
    fp32."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        torch.float32 if name == "frames" else torch.int64)


def for_arch(cfg: ArchConfig, seq_len: int, global_batch: int,
             seed: int = 0) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed,
        frames_dim=cfg.d_model if cfg.is_encdec else 0))
