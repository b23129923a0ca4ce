"""Deterministic synthetic data (`repro/data/pipeline.py`): token
batches in ``uniform`` and ``markov`` mode, the audio and vision stub
frontends' batches, their input specs, and a prefetching loader.

Tokens and embeddings are a counter-based function of (step, salt)
alone: numpy's Philox generator keyed by them, so every host computes
the same batch for a step with no state to keep.  They are not the
reference's values (it draws threefry bits through JAX, which the port
does not import); a test that needs the same inputs in both packages
hands them over.  The ``markov`` stream is the reference's construction
from the same source: a fixed bigram table of 4 successors a token,
each sequence a walk through it, so the stream is learnable (its
entropy is log 4, far below log V).  As in the reference, a model with a
frontend ignores ``mode``: MusicGen's batch is ``frames`` (B, T, D),
0.1 × a standard normal, with labels; Pixtral's is `N_PATCHES` patch
embeddings (B, 256, D), drawn alike, in front of T − 256 tokens.
"""
from __future__ import annotations

import collections
import threading
from functools import lru_cache
from typing import Dict, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape

SEED = 0x5EED
TABLE_SEED = 0xB16A      # the bigram table's key (the reference's table key)
WALK_SEED = 0xC4A1       # the walks' key, with the step
FRAMES_SEED = 0xA0D10    # the audio stub's key, with the step
PATCHES_SEED = 0x714E1   # the vision stub's key, with the step
SUCCESSORS = 4
MODES = ("uniform", "markov")
N_PATCHES = 256          # pixtral stub: vision patches per sequence


def _philox(*key: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=list(key)))


def _tokens(step: int, shape: tuple, vocab: int, salt: int = 0) -> torch.Tensor:
    """int32 tokens in [0, vocab), from Philox keyed by (step, salt)."""
    rng = _philox(SEED, step * 2 + salt)
    return torch.from_numpy(rng.integers(0, vocab, shape, dtype=np.int32))


@lru_cache(maxsize=8)
def successor_table(vocab: int) -> np.ndarray:
    """(vocab, 4) int32: each token's plausible successors, fixed."""
    return _philox(TABLE_SEED, 0).integers(0, vocab, (vocab, SUCCESSORS), dtype=np.int32)


def _markov_tokens(step: int, shape: tuple, vocab: int) -> torch.Tensor:
    """(B, T) int32: per sequence a first token and T successor choices
    keyed by ``step``; token t is the chosen successor of token t−1 (of
    the first token for t = 0)."""
    B, T = shape
    succ = successor_table(vocab)
    rng = _philox(WALK_SEED, step)
    tok = rng.integers(0, vocab, (B,), dtype=np.int32)
    choices = rng.integers(0, SUCCESSORS, (B, T), dtype=np.int32)
    out = np.empty((B, T), dtype=np.int32)
    for t in range(T):
        tok = succ[tok, choices[:, t]]
        out[:, t] = tok
    return torch.from_numpy(out)


def _embeddings(key: int, step: int, shape: tuple, dtype) -> torch.Tensor:
    """0.1 × a standard normal of ``shape`` from Philox keyed by (key,
    step), drawn in f32 and cast to ``dtype``."""
    x = _philox(key, step).standard_normal(shape, dtype=np.float32)
    return (torch.from_numpy(x) * 0.1).to(dtype)


def _check(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; have {MODES}")


def make_batch(cfg: ArchConfig, shape: InputShape, step: int,
               mode: str = "uniform",
               embed_dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """CPU tensors of ``shape`` (B = global_batch, T = seq_len): for a
    token model ``{"tokens", "labels"}``, (B, T) int32, labels the tokens
    shifted by one, ``mode`` "uniform" drawing every token alike and
    "markov" walking the bigram table; for the audio stub ``{"frames"
    (B, T, D) in ``embed_dtype``, "labels" (B, T)}``; for the vision stub
    ``{"patches" (B, N_PATCHES, D), "tokens", "labels" (B, T −
    N_PATCHES)}`` (`repro/data/pipeline.py:51-80`)."""
    _check(mode)
    B, T = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_frames":
        return {"frames": _embeddings(FRAMES_SEED, step, (B, T, cfg.d_model), embed_dtype),
                "labels": _tokens(step, (B, T), cfg.vocab_size, 1)}
    if cfg.frontend == "vision_patches":
        toks = _tokens(step, (B, T - N_PATCHES + 1), cfg.vocab_size)
        return {"patches": _embeddings(PATCHES_SEED, step, (B, N_PATCHES, cfg.d_model),
                                       embed_dtype),
                "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    draw = _markov_tokens if mode == "markov" else _tokens
    toks = draw(step, (B, T + 1), cfg.vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: InputShape,
                embed_dtype: torch.dtype = torch.bfloat16) -> Dict[str, TensorSpec]:
    """Shapes and dtypes of every model input of this shape
    (`repro/data/pipeline.py:87-116`): a decode step's one token (the
    audio stub's one frame), a prefill's tokens (frames; patches and the
    text tokens), and a training step's labels besides (of the text
    tail for the vision stub)."""
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.frontend == "audio_frames":
        if shape.kind == "decode":
            return {"frames": TensorSpec((B, 1, cfg.d_model), embed_dtype)}
        specs = {"frames": TensorSpec((B, T, cfg.d_model), embed_dtype)}
    elif shape.kind == "decode":
        return {"tokens": TensorSpec((B, 1), i32)}
    elif cfg.frontend == "vision_patches":
        T -= N_PATCHES
        specs = {"patches": TensorSpec((B, N_PATCHES, cfg.d_model), embed_dtype),
                 "tokens": TensorSpec((B, T), i32)}
    else:
        specs = {"tokens": TensorSpec((B, T), i32)}
    if shape.kind == "train":
        specs["labels"] = TensorSpec((B, T), i32)
    return specs


class DataLoader:
    """Batches made on a background thread, ``prefetch`` ahead: iterating
    yields ``(step, batch)`` from ``start_step`` on, the batches CPU
    tensors (`make_batch` with ``**kw``).  `close` (or leaving a ``with``
    block) stops the thread."""

    def __init__(self, cfg: ArchConfig, shape: InputShape, start_step: int = 0,
                 prefetch: int = 2, **kw):
        _check(kw.get("mode", "uniform"))
        self.cfg, self.shape, self.kw = cfg, shape, kw
        self.step, self.prefetch = start_step, prefetch
        self._ready: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="data-loader")
        self._thread.start()

    def _worker(self) -> None:
        s = self.step
        while True:
            batch = make_batch(self.cfg, self.shape, s, **self.kw)
            with self._cv:
                self._cv.wait_for(lambda: self._stop or len(self._ready) < self.prefetch)
                if self._stop:
                    return
                self._ready.append((s, batch))
                self._cv.notify_all()
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        with self._cv:
            self._cv.wait_for(lambda: self._ready)
            item = self._ready.popleft()
            self._cv.notify_all()
        return item

    def __enter__(self) -> "DataLoader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join()
