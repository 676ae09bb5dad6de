"""Deterministic synthetic LM data pipeline — torch port of
``repro.data.pipeline``.

Determinism is the fault-tolerance contract: the batch at step ``s`` is
a pure function of (seed, s), generated with a counter-based PRNG
(numpy's Philox, keyed as the JAX package keys it, so both packages
draw the same integers), so a restarted run resumes mid-stream with no
data-loader state to checkpoint, and elastic restarts see identical
batches regardless of host count.  Per-host sharding slices the global
batch by host id.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    # optional modality stubs
    n_patches: int = 0
    d_model: int = 0
    encdec: bool = False

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host)."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=np.uint64(step) * 1000 + self.host_id))
        b, s = self.host_batch, self.seq_len
        out: Dict[str, np.ndarray] = {}
        if self.encdec:
            s_src = s // 2
            out["src"] = rng.standard_normal(
                (b, s_src, self.d_model)).astype(np.float32)
            out["tokens"] = rng.integers(
                0, self.vocab, (b, s - s_src)).astype(np.int32)
        elif self.n_patches:
            out["tokens"] = rng.integers(
                0, self.vocab, (b, s - self.n_patches)).astype(np.int32)
            out["patches"] = rng.standard_normal(
                (b, self.n_patches, self.d_model)).astype(np.float32)
        else:
            out["tokens"] = rng.integers(0, self.vocab, (b, s)).astype(
                np.int32)
        return out

    def device_batch(self, step: int, device="cuda") -> Dict[str,
                                                            torch.Tensor]:
        """The host batch at ``step`` as torch tensors on ``device``."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(v).to(dev)
                for k, v in self.batch_at(step).items()}
