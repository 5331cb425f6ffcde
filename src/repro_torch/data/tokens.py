"""Synthetic token pipeline for LM training and smoke runs: seeded and
deterministic per step.

Port of ``repro.data.tokens``.  ``TokenStream`` is numpy and a copy of
the reference's, so its batches are the reference's bit for bit.
``random_batch`` draws uniform tokens from a ``torch.Generator`` where
the reference takes a ``jax.random`` key; the parity tests hand the
reference's batches across instead, since a torch generator cannot replay
threefry.
"""
from __future__ import annotations

import numpy as np
import torch


class TokenStream:
    """Markov-chain token generator — nontrivially learnable structure."""

    def __init__(self, vocab, *, seed=0, order_states=64):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.n_states = order_states
        self.trans = rng.dirichlet(0.3 * np.ones(order_states),
                                   size=order_states)
        self.emit = rng.dirichlet(0.1 * np.ones(vocab), size=order_states)
        self.seed = seed

    def batch(self, batch, seq, *, step=0):
        rng = np.random.default_rng((self.seed, step))
        out = np.zeros((batch, seq + 1), np.int32)
        state = rng.integers(0, self.n_states, batch)
        for t in range(seq + 1):
            for b in range(batch):
                out[b, t] = rng.choice(self.vocab, p=self.emit[state[b]])
                state[b] = rng.choice(self.n_states, p=self.trans[state[b]])
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}


def random_batch(generator, vocab, batch, seq):
    """Uniform int32 tokens in [0, vocab) from ``generator``, on its device
    -> {"tokens", "labels"} (B, seq), the labels shifted by one."""
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=generator,
                         dtype=torch.int32, device=generator.device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
