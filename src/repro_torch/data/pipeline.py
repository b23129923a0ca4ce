"""Deterministic synthetic data (`repro/data/pipeline.py`), token
frontends in ``uniform`` mode.

Tokens are a counter-based function of (step, salt) alone: numpy's
Philox generator keyed by them, so every host computes the same batch
for a step with no state to keep.  They are not the reference's tokens
(it draws threefry bits through JAX, which the port does not import);
a test that needs the same tokens in both packages hands them over.
The ``markov`` mode, the audio and vision frontends and the prefetching
loader wait for the training loop.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape

SEED = 0x5EED


def _tokens(step: int, shape: tuple, vocab: int, salt: int = 0) -> torch.Tensor:
    """int32 tokens in [0, vocab), from Philox keyed by (step, salt)."""
    rng = np.random.Generator(np.random.Philox(key=[SEED, step * 2 + salt]))
    return torch.from_numpy(rng.integers(0, vocab, shape, dtype=np.int32))


def make_batch(cfg: ArchConfig, shape: InputShape, step: int) -> Dict[str, torch.Tensor]:
    """``{"tokens", "labels"}``, (global_batch, seq_len) int32 CPU tensors
    of ``shape``, labels the tokens shifted by one."""
    if cfg.frontend:
        raise NotImplementedError(f"the {cfg.frontend} frontend is not ported yet")
    toks = _tokens(step, (shape.global_batch, shape.seq_len + 1), cfg.vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
