"""Deterministic resumable token stream for LM serving and training.
Counterpart of ``repro.data.tokens``.

Batches are a pure function of (seed, step, host_shard): after a restart
at step s every host regenerates the batches it would have seen, for any
host count (the global batch is carved by global index, not by host-local
RNG state). The draws are the reference's (the same ``numpy`` recipe), so
the tokens are bit-equal to its; they come back as int32 tensors on
``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["TokenStream"]


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # simple markovian structure so the LM loss has learnable signal
    n_states: int = 64

    def batch(self, step: int, *, host_id: int = 0, n_hosts: int = 1,
              device: str | torch.device = "cuda"):
        """Returns (tokens, labels), int32 [global_batch/n_hosts, seq_len]
        tensors on ``device``."""
        if self.global_batch % n_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not split over {n_hosts} hosts")
        local = self.global_batch // n_hosts
        rng = np.random.RandomState((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        # one transition matrix per stream (cheap, regenerated)
        probs = rng.dirichlet(np.full(self.n_states, 0.3), size=self.n_states)
        emit = rng.randint(0, self.vocab, size=self.n_states)
        out = np.empty((self.global_batch, self.seq_len), np.int32)
        state = rng.randint(0, self.n_states, size=self.global_batch)
        for t in range(self.seq_len):
            out[:, t] = emit[state]
            u = rng.rand(self.global_batch, 1)
            state = (probs[state].cumsum(1) < u).sum(1).clip(0, self.n_states - 1)
        shard = out[host_id * local : (host_id + 1) * local]
        tokens = torch.from_numpy(shard).to(resolve_device(device))
        return tokens, tokens
