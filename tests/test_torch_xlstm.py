"""xLSTM's layers and the sliding window alone, on the CPU against the JAX
package: mLSTM (both of its scans through the port's `ssd_scan`, with the
cache's C and n as initial states) and sLSTM (the loop over tokens) on a
prompt and then on decode steps, their caches, and GQA attention with a
window through a prefill and decode steps past the window.  Tolerance
1e-4·max(1, max |reference|) per tensor (`test_torch_models.assert_close`).

Also why the whole reduced xLSTM is held to the reference on the
rescaled tree (`test_torch_models.fan_in_rescaled`, as Zamba2 is): at the
reference's own init its layers grow the residual to ~10², and a one-ulp
move of its own weights moves its own logits by a sizeable share of the
bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import xlstm as jx
from repro.models.spec import init_params as jinit_params
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import xlstm as px
from tests.test_torch_models import (
    TOL,
    assert_close,
    assert_tree_close,
    fan_in_rescaled,
    jit_cfg,
    port_params,
    rng_arrays,
    same_cfg,
    to_np,
    tokens,
)


@pytest.fixture(scope="module")
def cfgs():
    return same_cfg("xlstm-350m", n_layers=8)


def _layer(cfgs, name: str, seed):
    """The reference's init of one layer's specs and the port's layer
    holding those weights."""
    cfg, jcfg = cfgs
    jp = to_np(jinit_params(getattr(jx, name)(jcfg), jax.random.PRNGKey(seed)))
    return jp, port_params(getattr(px, name)(cfg), jp)


def _run_both(cfgs, apply_j, apply_p, jp, p, init_j, init_p, T: int, steps: int, seed: int):
    """A prompt of T positions, then ``steps`` one-position calls, through
    the layer in both packages with f32 caches: outputs and caches after
    each call within TOL; also the cache-free call on the prompt."""
    cfg, jcfg = cfgs
    xs = rng_arrays(seed, (2, T, cfg.d_model), *[(2, 1, cfg.d_model)] * steps)
    want, _ = apply_j(jp, jnp.asarray(xs[0]), jcfg)
    with torch.inference_mode():
        got, _ = apply_p(p, torch.from_numpy(xs[0]), cfg)
    assert_close(got, want, "no cache")
    jcache = init_j(jcfg, 2, jnp.float32)
    cache = init_p(cfg, 2, torch.float32, "cpu")
    for i, x in enumerate(xs):
        want, jcache = apply_j(jp, jnp.asarray(x), jcfg, cache=jcache)
        with torch.inference_mode():
            got, cache = apply_p(p, torch.from_numpy(x), cfg, cache=cache)
        assert_close(got, want, f"call {i}")
        assert_tree_close(cache, jcache, f"cache after call {i}")


def test_mlstm_prompt_then_steps_match_the_reference(cfgs):
    jp, p = _layer(cfgs, "mlstm_specs", 1)
    _run_both(cfgs, jit_cfg(jx.mlstm_apply), px.mlstm_apply, jp, p,
              jx.init_mlstm_cache, px.init_mlstm_cache, T=150, steps=3, seed=2)


def test_slstm_prompt_then_steps_match_the_reference(cfgs):
    jp, p = _layer(cfgs, "slstm_specs", 3)
    _run_both(cfgs, jit_cfg(jx.slstm_apply), px.slstm_apply, jp, p,
              jx.init_slstm_cache, px.init_slstm_cache, T=40, steps=3, seed=4)


def test_xlstm_caches_are_the_references():
    """`init_cache`: mLSTM buffers stacked (groups, k−1), sLSTM ones
    (groups); the conv tail in the cache dtype, the memories f32, the
    sLSTM stabiliser at −10; equal to the reference's, leaf by leaf."""
    cfg, jcfg = same_cfg("xlstm-350m", n_layers=8)
    m = build_model(cfg, device="cpu", seed=0)
    cache = m.init_cache(3, 10, torch.bfloat16)
    jcache = jbuild_model(jcfg).init_cache(3, 10, jnp.bfloat16)
    for part in ("mlstm", "slstm"):
        for got, want in zip(cache[part], jcache[part]):
            assert tuple(got.shape) == want.shape
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert cache["mlstm"].C.shape == (2, 3, 3, 4, 64, 64)
    assert float(cache["slstm"].m.max()) == -10.0


@pytest.mark.parametrize("window", [8, 30])
def test_gqa_window_prefill_and_decode_past_the_window(window):
    """GQA with a window through a 40-token prefill and 4 decode steps,
    every query past the window: outputs and caches equal the reference's
    (`_attend_cache` masks keys ``window`` or more positions behind)."""
    cfg, jcfg = same_cfg("gemma3-27b")
    jp = to_np(jinit_params(jattn.gqa_specs(jcfg), jax.random.PRNGKey(5)))
    p = port_params(attn.gqa_specs(cfg), jp)
    T, steps, s_max = 40, 4, 48
    xs = rng_arrays(6, (2, T, cfg.d_model), *[(2, 1, cfg.d_model)] * steps)
    japply = jax.jit(jattn.gqa_apply, static_argnums=(2, 4))
    jcache = jattn.init_kv_cache(jcfg, 2, s_max, jnp.float32)
    cache = attn.init_kv_cache(cfg, 2, s_max, torch.float32, "cpu")
    n = 0
    for i, x in enumerate(xs):
        L = x.shape[1]
        pos = np.broadcast_to(np.arange(n, n + L)[None], (2, L)).astype(np.int32)
        want, jcache = japply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), window,
                              jcache, jnp.asarray(n, jnp.int32))
        with torch.inference_mode():
            got, cache = attn.gqa_apply(p, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                                        window=window, cache=cache, cache_len=n)
        assert_close(got, want, f"window {window} call {i}")
        assert_tree_close(cache, jcache, f"window {window} cache {i}")
        n += L
    # the window changes the result: the same last step without it differs
    with torch.inference_mode():
        full, _ = attn.gqa_apply(p, torch.from_numpy(xs[-1]), cfg,
                                 torch.full((2, 1), n - 1), cache=cache, cache_len=n - 1)
    assert not torch.allclose(full, got)


def test_xlstm_reference_scale_is_ill_conditioned():
    """On the reference's own ``init`` tree of the reduced xLSTM (8 layers),
    moving each weight one ulp moves the reference's own logits by at
    least a fifth of the 1e-4 bound; on the rescaled tree by under a
    tenth of it: the models are held to each other there."""
    _, jcfg = same_cfg("xlstm-350m", n_layers=8)
    jm = jbuild_model(jcfg)
    fwd = jax.jit(jm.forward)
    batch = {"tokens": jnp.asarray(tokens(30, (2, 40), jcfg.vocab_size))}
    own = to_np(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def one_ulp(a):
        way = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf).astype(a.dtype)
        return np.nextafter(a, way)

    for params, lo, hi in ((own, 0.2, None), (fan_in_rescaled(jm, own), None, 0.1)):
        base = np.asarray(fwd(params, batch)[0])
        moved = np.asarray(fwd(jax.tree.map(one_ulp, params), batch)[0])
        ratio = float(np.abs(moved - base).max()) / (TOL * max(1.0, float(np.abs(base).max())))
        assert lo is None or ratio >= lo, ratio
        assert hi is None or ratio < hi, ratio
