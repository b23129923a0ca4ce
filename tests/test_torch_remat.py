"""Activation remat (`Model(remat=...)`, `repro/models/model.py:178-186,
205, 220`) on the CPU.

- Loss and every parameter's gradient bitwise equal across "none",
  "full" and "dots" for a reduced config of each family (dense, moe,
  hybrid, ssm at 8 layers, audio on frames, vlm on its 256 patches and
  24 tokens), f32: a
  recompute repeats the forward's operations on the same values.
- The recompute happens: the attention's and the scan's plain versions
  run twice per layer under "full" (the forward and its recompute),
  twice under "dots" in the attention stacks, once in the hybrid and
  ssm families there (the reference honours only "full" for them).
- Fewer bytes saved for the backward under "full" (counted by
  `torch.autograd.graph.saved_tensors_hooks`, each storage once).
- Gradients under "full" and "dots" against the reference's
  ``jax.value_and_grad`` of its ``Model(remat=...)`` on the same tree and
  batch, within `test_torch_train.py`'s GRAD_TOL.
- Serving is untouched (no grad: logits bitwise the non-remat model's);
  an unknown remat raises.
"""
import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.data.pipeline import N_PATCHES, make_batch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import Model, build_model
from tests.test_torch_models import assert_close, pair
from tests.test_torch_train import GRAD_TOL, _batch, _by_name, _j, _t

FAMILIES = {"dense": ("qwen3-14b", {}), "moe": ("deepseek-v2-lite-16b", {}),
            "hybrid": ("zamba2-1.2b", {}), "ssm": ("xlstm-350m", {"n_layers": 8}),
            "audio": ("musicgen-medium", {}), "vlm": ("pixtral-12b", {})}
REMATS = ("none", "full", "dots")


def _cfg(family):
    name, kw = FAMILIES[family]
    return dataclasses.replace(get_arch(name).reduced(), **kw)


def _grads(model, batch):
    params = [p for _, p in model.named_parameters()]
    for p in params:
        p.requires_grad_(True)
    try:
        loss, _ = model.loss(batch)
        return loss, torch.autograd.grad(loss, params, materialize_grads=True)
    finally:
        for p in params:
            p.requires_grad_(False)


def _models(family):
    cfg = _cfg(family)
    seq = 24 + (N_PATCHES if cfg.frontend == "vision_patches" else 0)
    batch = make_batch(cfg, InputShape("t", seq, 2, "train"), 0,
                       embed_dtype=torch.float32)
    return {r: build_model(cfg, device="cpu", seed=1, remat=r) for r in REMATS}, batch


@pytest.fixture
def plain_calls(monkeypatch):
    """Calls of the attention's and the scan's plain versions."""
    calls = Counter()
    for mod, name, kind in ((flash_ops, "flash_ref", "attention"),
                            (scan_ops, "ssd_chunk_ref", "scan")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _kind=kind, **kw):
            calls[_kind] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gradients_are_bitwise_the_plain_ones(family, plain_calls):
    models, batch = _models(family)
    got = {}
    for r, m in models.items():
        plain_calls.clear()
        got[r] = _grads(m, batch)
        calls = dict(plain_calls)
        if r == "none":
            base = calls
            continue
        again = r == "full" or family in ("dense", "moe", "audio", "vlm")
        assert calls == {k: n * 2 for k, n in base.items()} if again else calls == base, \
            (r, calls, base)
    loss, grads = got["none"]
    for r in ("full", "dots"):
        assert torch.equal(got[r][0], loss), r
        for (n, _), g, g0 in zip(models[r].named_parameters(), got[r][1], grads):
            assert torch.equal(g, g0), (r, n)


def _saved_bytes(model, batch) -> int:
    seen, total = set(), [0]

    def pack(t):
        key = (t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
        if key not in seen:
            seen.add(key)
            total[0] += key[1]
        return t
    params = [p for _, p in model.named_parameters()]
    for p in params:
        p.requires_grad_(True)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model.loss(batch)
        del loss
    finally:
        for p in params:
            p.requires_grad_(False)
    return total[0]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_full_remat_saves_fewer_bytes_for_backward(family):
    models, batch = _models(family)
    none, full = (_saved_bytes(models[r], batch) for r in ("none", "full"))
    assert full < none, (full, none)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", ["qwen3-14b", "zamba2-1.2b", "deepseek-v2-lite-16b"])
def test_remat_gradients_against_the_references(name, remat):
    """The port's remat gradients against the reference's remat gradients
    (its `jax.checkpoint` of each scanned layer) on its own init tree."""
    pr = pair(name)
    jm = dataclasses.replace(pr.jmodel, remat=remat)
    model = build_model(pr.cfg, device="cpu", seed=None, remat=remat)
    model.load_state_dict(pr.model.state_dict())
    batch = _batch(pr, 31)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(pr.params, _j(batch))
    loss, grads = _grads(model, _t(batch))
    assert_close(loss, jl, "loss")
    want = _by_name(pr, jg)
    for (n, _), g in zip(model.named_parameters(), grads):
        assert_close(g, want[n], f"grad {n}", GRAD_TOL[name])


def test_remat_leaves_serving_untouched():
    cfg = _cfg("hybrid")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12),
                                                              dtype=np.int32))
    out = {}
    for r in ("none", "full"):
        m = build_model(cfg, device="cpu", seed=1, remat=r)
        with torch.inference_mode():
            cache = m.init_cache(2, 16, torch.float32)
            out[r] = m.prefill({"tokens": toks}, cache)[0]
    assert torch.equal(out["full"], out["none"])
    with pytest.raises(ValueError, match="remat"):
        Model(cfg, device="meta", remat="selective")
