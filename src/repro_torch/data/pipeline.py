"""Deterministic, shardable, checkpointable synthetic token pipeline.

The port of ``repro.data.pipeline``: the same numpy calls in the same
order, so its batches are bit for bit the reference's.  Every batch is a
pure function of (seed, step, shard): an infinite stream of pseudo-random
"documents" from a counter-based generator, with no data files; each data
shard draws its own counter range, and the pipeline's state is one integer
that a checkpoint carries.  ``to_device`` moves a batch to the card (or
another device) for ``train_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.mesh import resolve_device
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_json(self) -> dict:
        return {"step": self.step}

    @staticmethod
    def from_json(d: dict) -> "PipelineState":
        return PipelineState(step=int(d.get("step", 0)))


@dataclasses.dataclass
class TokenPipeline:
    cfg: ArchConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    state: PipelineState = dataclasses.field(default_factory=PipelineState)

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError(
                f"global batch {self.global_batch} does not split over {self.n_shards} shards"
            )
        self.local_batch = self.global_batch // self.n_shards

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, shard)."""
        # counter-based: one Philox stream keyed by (seed, step, shard)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.shard]))
        b, s = self.local_batch, self.seq_len
        # synthetic "documents": zipf-ish token frequencies + markov-ish runs
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        tokens = (base % (self.cfg.vocab - 2)) + 1
        runs = rng.integers(0, 4, size=(b, s)) == 0
        tokens = np.where(runs, np.roll(tokens, 1, axis=1), tokens)
        tokens = tokens.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.encdec:
            out["enc_emb"] = (
                rng.standard_normal((b, self.cfg.max_source_positions, self.cfg.d_model)).astype(
                    np.float32
                )
                * 0.02
            )
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        batch = self._batch_at(self.state.step)
        self.state.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- fault tolerance --------------------------------------------------------

    def snapshot(self) -> dict:
        return self.state.to_json()

    def restore(self, snap: dict) -> None:
        self.state = PipelineState.from_json(snap)

    def reshard(self, n_shards: int, shard: int) -> "TokenPipeline":
        """Elastic re-shard: same global stream, new shard geometry (the
        counter key includes the shard id, so each shard's stream stays
        deterministic; batches are pure functions of the step)."""
        return TokenPipeline(
            cfg=self.cfg,
            global_batch=self.global_batch,
            seq_len=self.seq_len,
            seed=self.seed,
            n_shards=n_shards,
            shard=shard,
            state=PipelineState(step=self.state.step),
        )


def to_device(batch: Dict[str, np.ndarray], cfg: ArchConfig, device=None) -> Dict[str, torch.Tensor]:
    """A batch as tensors on ``device`` (``None`` means CUDA): ``tokens`` and
    ``labels`` int32, ``enc_emb`` in the model's dtype, which the port's
    encoder takes (the reference adds its f32 frames to its positions as
    they come)."""
    device = resolve_device(device)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    if "enc_emb" in out:
        out["enc_emb"] = out["enc_emb"].to(getattr(torch, cfg.dtype))
    return out
