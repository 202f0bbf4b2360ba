"""Deterministic, shardable synthetic data pipelines: the port's own copy
of the JAX package's ``data/pipeline.py`` (numpy only), so that a batch is
byte-identical to the reference's for any seed, step and host shard.

``SyntheticLM``: counter-based generation — batch(step) is a pure function of
(seed, step, host shard), so a restarted run replays the exact token stream
(required for bitwise-identical resume after failure; see checkpoint tests).

``MarkovLM``: tokens from a fixed random 2-gram chain — has learnable
structure, so the end-to-end training example shows a real loss curve, not
noise memorization.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Counter-based uniform tokens. batch_at(step) is stateless/deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        # Philox counter RNG keyed on (seed, step, host) — O(1) seek.
        bits = np.random.Philox(key=c.seed,
                                counter=[0, 0, step, c.host_index])
        rng = np.random.Generator(bits)
        tokens = rng.integers(0, c.vocab_size,
                              (c.host_batch, c.seq_len + 1), dtype=np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MarkovLM:
    """2-gram Markov chain with a fixed random transition table (learnable)."""

    def __init__(self, cfg: DataConfig, branching: int = 4):
        self.cfg = cfg
        master = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Each token transitions to `branching` successors with skewed probs.
        self.successors = master.integers(0, v, (v, branching))
        probs = master.dirichlet(np.ones(branching) * 0.5, size=v)
        self.probs = probs

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        bits = np.random.Philox(key=c.seed + 1,
                                counter=[0, 0, step, c.host_index])
        rng = np.random.Generator(bits)
        b, s = c.host_batch, c.seq_len + 1
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, c.vocab_size, b)
        for t in range(1, s):
            choice = (rng.random(b)[:, None]
                      > np.cumsum(self.probs[toks[:, t - 1]], -1)).sum(-1)
            choice = np.minimum(choice, self.successors.shape[1] - 1)
            toks[:, t] = self.successors[toks[:, t - 1], choice]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
