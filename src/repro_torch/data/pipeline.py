"""Deterministic synthetic token pipeline.

Production shape: stateful iterator with an explicit, checkpointable
state (epoch, step, PRNG key), shardable across data-parallel hosts
(each host generates only its local slice), and restartable to the exact
batch after preemption -- the properties a real data loader must have
for fault-tolerant training; the token source here is synthetic (a
mixture of Zipf-distributed unigrams and repeated motifs so models have
non-trivial structure to learn).

The JAX package's ``repro.data.pipeline``, copied: numpy only, so every
batch, host slice and ``state_dict`` resume is bit-equal to the
reference's.  Batches stay numpy; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int = 1024
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    input_mode: str = "tokens"    # tokens | embeddings
    d_model: int = 0              # for embeddings mode
    motif_len: int = 16
    n_motifs: int = 64


class SyntheticPipeline:
    """state = (step,); every batch is a pure function of (seed, step,
    host_slice) so resume-after-restart is exact."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        if cfg.global_batch % host_count:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self.step = 0
        root = np.random.default_rng(cfg.seed)
        # fixed motif bank (part of the dataset definition, not the state)
        self._motifs = root.integers(
            1, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len))
        # Zipf-ish unigram distribution
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step}

    def load_state_dict(self, state: Dict):
        self.step = int(state["step"])

    # -- batch generation ----------------------------------------------------
    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, step, self.host_index))

    def _tokens(self, rng, b, s):
        toks = rng.choice(self.cfg.vocab_size, size=(b, s),
                          p=self._probs).astype(np.int32)
        # overwrite random spans with motifs (learnable structure)
        n_spans = max(1, s // (2 * self.cfg.motif_len))
        for i in range(b):
            for _ in range(n_spans):
                m = rng.integers(0, self.cfg.n_motifs)
                start = rng.integers(0, max(1, s - self.cfg.motif_len))
                L = min(self.cfg.motif_len, s - start)
                toks[i, start:start + L] = self._motifs[m, :L]
        return toks

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng_for(self.step)
        self.step += 1
        b, s = self.local_batch, cfg.seq_len
        toks = self._tokens(rng, b, s + 1)
        if cfg.input_mode == "tokens":
            return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        emb = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        return {"inputs": emb, "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
