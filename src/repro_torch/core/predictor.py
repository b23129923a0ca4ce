"""Lightweight dynamic concurrency predictor, paper §4.3
(`repro/core/predictor.py`).

Multi-class (one-vs-rest softmax) logistic regression:
    P = softmax(X @ W);  CD_exec = min(argmax P, available GEMMs)
Classes: {1S} ∪ {cP : c ∈ CDS}.  Features (paper Fig. 7b): log2 of the
op's (M, N, K)-like sizes + per-CD kernel features (log2 #WGs, occupancy,
log2 #waves) of the GO kernels, 3 + 3·|CDS| dims (27 with the default
CDS), min-max normalized.  Features and inference are host NumPy, the
reference's arithmetic, so a predictor carried across (the reference's
`Predictor.save` JSON, or `Predictor.from_numpy`) predicts the same CDs
bitwise; inference sits on the dispatch fast path, where a tensor on the
card would cost a synchronisation per decision.  Training is torch on an
explicit device (`train_predictor`): the reference's loss and Adam
update in the reference's order.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import (
    DEFAULT_SPEC,
    TileBatch,
    TPUSpec,
    kernel_stats_batch,
)
from repro_torch.core.device import resolve_device
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.library import GOLibrary
from repro_torch.core.tuner import CDS

CLASSES = (1,) + tuple(CDS)  # 1S, 2P, …, 8P, 16P


def op_features(
    desc, lib: GOLibrary, spec: TPUSpec = DEFAULT_SPEC
) -> np.ndarray:
    """Family-generic feature vector (3 + 3·|CDS| dims): log2 of the
    family's (M, N, K)-like size triple (`mnk_like`; for a GEMM M, N, K)
    + per-CD (log2 #WGs, occupancy, log2 #waves) of the GO kernels, all
    CDs' kernel stats from one batched model call."""
    entry = lib.get(desc)
    m, n, k = desc.mnk_like
    feats = [math.log2(max(m, 1)), math.log2(max(n, 1)),
             math.log2(max(k, 1))]
    st = kernel_stats_batch(
        desc,
        TileBatch.from_tiles([entry.tile_for_cd(cd) for cd in CDS]),
        vmem_budget=np.asarray([spec.vmem_bytes // cd for cd in CDS],
                               np.int64),
        spec=spec,
    )
    for i in range(len(CDS)):
        feats += [
            math.log2(max(int(st.n_tiles[i]), 1)),
            float(st.occupancy[i]),
            math.log2(max(float(st.waves[i]), 1e-6)),
        ]
    return np.asarray(feats, np.float32)


def gemm_features(
    desc: GemmDesc, lib: GOLibrary, spec: TPUSpec = DEFAULT_SPEC
) -> np.ndarray:
    """GEMM feature vector: `op_features` under the paper's name."""
    return op_features(desc, lib, spec)


@dataclass
class Predictor:
    W: np.ndarray          # (F+1, C)
    f_min: np.ndarray      # (F,)
    f_max: np.ndarray      # (F,)
    # Memoized CD decisions: (desc key, availability class) → CD_exec,
    # filled lazily; the features closure runs only on a miss, so a warm
    # dispatch performs no cost-model evaluation.
    _cd_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @staticmethod
    def from_numpy(W, f_min, f_max) -> "Predictor":
        """A predictor from its arrays (as float32, the JSON's dtype)."""
        return Predictor(np.asarray(W, np.float32),
                         np.asarray(f_min, np.float32),
                         np.asarray(f_max, np.float32))

    # ---------------------------------------------------------------- api
    def _norm(self, X: np.ndarray) -> np.ndarray:
        span = np.where(self.f_max > self.f_min, self.f_max - self.f_min, 1.0)
        Xn = (X - self.f_min) / span
        ones = np.ones((*Xn.shape[:-1], 1), Xn.dtype)
        return np.concatenate([Xn, ones], axis=-1)

    def probabilities(self, X: np.ndarray) -> np.ndarray:
        logits = self._norm(np.atleast_2d(X)) @ self.W
        z = logits - logits.max(-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(-1, keepdims=True)

    def predict_cd(self, X: np.ndarray, available: int = 16) -> np.ndarray:
        """Paper Fig. 8: CD = min(argmax P, available)."""
        p = self.probabilities(X)
        cd = np.asarray(CLASSES)[p.argmax(-1)]
        return np.minimum(cd, _floor_class(available))

    def predict_cd_one(self, key: str, features, available: int = 16) -> int:
        """Memoized single-op `predict_cd`, the dispatch fast path.
        ``features`` is the feature vector or a zero-argument callable
        producing it, called only on a miss.  Keyed on the availability
        class (`_floor_class`), which is what the min quantizes on."""
        k = (key, _floor_class(available))
        hit = self._cd_cache.get(k)
        if hit is not None:
            return hit
        x = features() if callable(features) else features
        cd = int(self.predict_cd(np.atleast_2d(x), available=available)[0])
        self._cd_cache[k] = cd
        return cd

    def invalidate_cache(self) -> None:
        self._cd_cache.clear()

    # ------------------------------------------------------------ persist
    def save(self, path) -> None:
        """The reference's JSON: ``W``, ``f_min``, ``f_max`` as lists."""
        Path(path).write_text(json.dumps({
            "W": self.W.tolist(),
            "f_min": self.f_min.tolist(),
            "f_max": self.f_max.tolist(),
        }))

    @staticmethod
    def load(path) -> "Predictor":
        d = json.loads(Path(path).read_text())
        return Predictor.from_numpy(d["W"], d["f_min"], d["f_max"])


def _floor_class(avail: int) -> int:
    return max(c for c in CLASSES if c <= max(avail, 1))


# ---------------------------------------------------------------- training
def train_predictor(
    X: np.ndarray,
    y: np.ndarray,  # class indices into CLASSES
    *,
    epochs: int = 600,
    lr: float = 0.15,
    l2: float = 1e-4,
    seed: int = 0,
    w0: np.ndarray | None = None,
    device="cuda",
) -> Predictor:
    """Full-batch Adam on the NLL of ``log_softmax(Xn @ W)`` + l2·ΣW²
    (`repro/core/predictor.py:155-198`), in float32 on ``device``
    (CUDA unless the caller passes ``device="cpu"``; raises without it).
    The gradient is autograd's; the update is the reference's, in its
    order: m, v, bias corrections in float32, W −= lr·m̂/(√v̂ + 1e-8).
    ``w0`` is the initial (F+1, C) weights; without it, 0.01·N(0, 1)
    from a `torch.Generator` seeded with ``seed`` on ``device`` (the
    reference's `jax.random` draw has no torch twin)."""
    dev = resolve_device(device)
    f_min, f_max = X.min(0), X.max(0)
    span = np.where(f_max > f_min, f_max - f_min, 1.0)
    Xn = (X - f_min) / span
    Xn = np.concatenate([Xn, np.ones((len(Xn), 1), np.float32)], 1)
    Xd = torch.from_numpy(np.ascontiguousarray(Xn, np.float32)).to(dev)
    yd = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    shape = (Xn.shape[1], len(CLASSES))
    if w0 is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        W = 0.01 * torch.randn(shape, generator=gen, device=dev)
    else:
        W = torch.from_numpy(np.array(w0, np.float32)).to(dev)
        if tuple(W.shape) != shape:
            raise ValueError(f"w0 has shape {tuple(W.shape)}, expected {shape}")
    m = torch.zeros_like(W)
    v = torch.zeros_like(W)
    rows = torch.arange(len(yd), device=dev)
    b1 = torch.tensor(0.9, dtype=torch.float32, device=dev)
    b2 = torch.tensor(0.999, dtype=torch.float32, device=dev)
    for i in range(epochs):
        W.requires_grad_(True)
        lp = torch.log_softmax(Xd @ W, -1)
        loss = -lp[rows, yd].mean() + l2 * (W ** 2).sum()
        (g,) = torch.autograd.grad(loss, W)
        W = W.detach()
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - b1 ** (i + 1))
        vh = v / (1 - b2 ** (i + 1))
        W = W - lr * mh / (torch.sqrt(vh) + 1e-8)
    return Predictor.from_numpy(W.cpu().numpy(), f_min, f_max)


# ------------------------------------------------------------- the dataset
def profile_dataset(
    descs: Sequence[GemmDesc],
    lib: GOLibrary,
    spec: TPUSpec = DEFAULT_SPEC,
    threshold: float = 1.05,
) -> tuple[np.ndarray, np.ndarray]:
    """Offline profiling (paper Fig. 7b): features ↦ preferred CD."""
    X, y = [], []
    for d in descs:
        e = lib.get(d)
        X.append(gemm_features(d, lib, spec))
        y.append(CLASSES.index(e.preferred_cd(threshold)))
    return np.stack(X), np.asarray(y, np.int32)


def generate_gemm_pool(n: int = 1072, seed: int = 17) -> list[GemmDesc]:
    """GEMM pool matching the paper's ranges (§5.2): output 32K–168M,
    K 64–20K, both precisions, all transpose combinations; the
    reference's draws from the same NumPy generator, so the same pool."""
    rng = np.random.default_rng(seed)
    descs: list[GemmDesc] = []
    sizes = [32, 64, 128, 256, 384, 512, 768, 1024, 1600, 2048, 3072, 4096,
             5120, 8192, 12288, 16384]
    ks = [64, 128, 256, 512, 768, 1024, 2048, 3072, 4096, 5120, 8192, 12288,
          16384, 20480]
    seen = set()
    while len(descs) < n:
        M = int(rng.choice(sizes))
        N = int(rng.choice(sizes))
        if not (32_768 <= M * N <= 168_000_000):
            continue
        K = int(rng.choice(ks))
        ta, tb = bool(rng.integers(2)), bool(rng.integers(2))
        dtype = "bf16" if rng.random() < 0.5 else "f32"
        d = GemmDesc(M, N, K, ta, tb, dtype)
        if d.key() in seen:
            continue
        seen.add(d.key())
        descs.append(d)
    return descs


def accuracy_by_available(
    pred: Predictor, X: np.ndarray, y: np.ndarray
) -> dict[int, float]:
    """Paper §6.6: accuracy for 2/4/8/16 available GEMMs; a prediction is
    right when min(pred, avail) == min(label, avail)."""
    out = {}
    ytrue = np.asarray(CLASSES)[y]
    for avail in (2, 4, 8, 16):
        p = pred.predict_cd(X, available=avail)
        t = np.minimum(ytrue, avail)
        out[avail] = float((p == t).mean())
    return out
