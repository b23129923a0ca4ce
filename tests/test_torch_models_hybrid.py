"""The port's Mamba2 block (`repro_torch.models.ssm`) and Zamba2-1.2B
(reduced: 4 layers, the shared attention block every 2nd, float32) on
the CPU against the JAX package, on the same weights and inputs.

Prompts of 40 and 200 tokens: neither is a multiple of the scan's chunk
(128), and 200 spans two chunks, so the chunked form's last chunk is
short.  A decode step (T = 1) takes the scan with the cached state.
Tolerance as in `test_torch_models.py`: max |Δ| ≤ 1e-4·max(1, max|ref|);
greedy tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.models.spec import init_params as jinit_params
from repro_torch.models import blocks, ssm
from tests.test_torch_models import (
    assert_close,
    TOL,
    assert_tree_close,
    fan_in_rescaled,
    greedy_both,
    jit_cfg,
    jit_cfg_at,
    pair,
    port_params,
    rng_arrays,
    same_cfg,
    serve_both,
    to_np,
    tokens,
)


def _mamba_pair(seed: int):
    cfg, jcfg = same_cfg("zamba2-1.2b")
    jp = to_np(jinit_params(jssm.mamba_specs(jcfg), jax.random.PRNGKey(seed)))
    return cfg, jcfg, jp, port_params(ssm.mamba_specs(cfg), jp)


@pytest.mark.parametrize("with_prefix", [False, True])
def test_causal_conv_against_reference(with_prefix):
    x, w, b, pre = rng_arrays(0, (2, 9, 12), (4, 12), (12,), (2, 3, 12))
    t = [torch.from_numpy(a) for a in (x, w, b, pre)]
    out, tail = ssm._causal_conv(*t[:3], prefix=t[3] if with_prefix else None)
    jout, jtail = jssm._causal_conv(x, w, b, prefix=pre if with_prefix else None)
    assert_close(out, jout, "conv out")
    assert_close(tail, jtail, "conv tail")


@pytest.mark.parametrize("T", [40, 200])
def test_mamba_block_without_cache(T):
    cfg, jcfg, jp, p = _mamba_pair(1)
    (x,) = rng_arrays(2, (2, T, cfg.d_model))
    y, cache = ssm.mamba_apply(p, torch.from_numpy(x), cfg)
    jy, _ = jit_cfg(jssm.mamba_apply)(jp, jnp.asarray(x), jcfg)
    assert cache is None
    assert_close(y, jy, f"mamba y, T={T}")


@pytest.mark.parametrize("T", [40, 200])
def test_mamba_block_prefill_then_decode(T):
    """A prompt on the chunked form from a zero state, then two decode
    steps from the cached state and conv tail: y and both cache buffers,
    the cache updated in place."""
    cfg, jcfg, jp, p = _mamba_pair(3)
    B = 2
    x, x1, x2 = rng_arrays(4, (B, T, cfg.d_model), (B, 1, cfg.d_model),
                           (B, 1, cfg.d_model))
    cache = ssm.init_mamba_cache(cfg, B, torch.float32, "cpu")
    ptrs = [t.data_ptr() for t in cache]
    jcache = jssm.init_mamba_cache(jcfg, B, jnp.float32)
    jmamba = jit_cfg(jssm.mamba_apply)
    for i, xs in enumerate((x, x1, x2)):
        y, cache = ssm.mamba_apply(p, torch.from_numpy(xs), cfg, cache=cache)
        jy, jcache = jmamba(jp, jnp.asarray(xs), jcfg, cache=jcache)
        assert_close(y, jy, f"mamba call {i} y")
        assert_tree_close(cache, jcache, f"mamba call {i} cache")
    assert [t.data_ptr() for t in cache] == ptrs


def test_zamba_layer_applies_the_shared_block_on_its_period():
    """Layer i runs the shared attention block iff i % attn_every ==
    attn_every − 1, on its own KV cache; the other layers leave their KV
    cache untouched."""
    pr = pair("zamba2-1.2b", seed=5)
    cfg = pr.cfg
    B, T, S = 1, 6, 8
    (x,) = rng_arrays(6, (B, T, cfg.d_model))
    pos = torch.arange(T)[None]
    jshared = pr.params["shared"]
    jlayer = jit_cfg_at(jblocks.zamba_layer_apply, 3)
    for i in range(cfg.n_layers):
        cache = pr.model.init_cache(B, S, torch.float32)
        jcache = pr.jmodel.init_cache(B, S, jnp.float32)
        c = {"mamba": ssm.MambaCache(*(t[i] for t in cache["mamba"])),
             "kv": type(cache["kv"])(*(t[i] for t in cache["kv"]))}
        jc = jax.tree.map(lambda a: a[i], jcache)
        jp = jax.tree.map(lambda a: a[i], pr.params["layers"])
        y, c = blocks.zamba_layer_apply(pr.model.layers[i], pr.model.shared,
                                        torch.from_numpy(x), cfg, pos, i,
                                        cache=c, cache_len=0)
        jy, jc = jlayer(jp, jshared, jnp.asarray(x), cfg, jnp.asarray(pos.numpy()),
                        jnp.int32(i), cache=jc, cache_len=jnp.int32(0))
        assert_close(y, jy, f"zamba layer {i}")
        assert_tree_close(c, jc, f"zamba layer {i} cache")
        shared = i % cfg.attn_every == cfg.attn_every - 1
        assert bool(c["kv"].k.abs().sum() > 0) == shared


@pytest.mark.parametrize("T,own_min", [(40, 0.5), (200, 1.0)])
def test_zamba2_reference_scale_is_ill_conditioned(T, own_min):
    """Why the reduced Zamba2 is held to the reference on rescaled weights
    (`fan_in_rescaled`): on the reference's own ``init`` tree, moving each
    weight one ulp (up or down at random) moves the reference's own
    forward logits by at least ``own_min`` of the 1e-4 bound (above it at
    200 tokens), so no evaluation in another summation order can be held
    to the bound there; on the rescaled tree the same change moves them by
    under a tenth of it."""
    _, jcfg = same_cfg("zamba2-1.2b")
    jm = jbuild_model(jcfg)
    fwd = jax.jit(jm.forward)
    batch = {"tokens": jnp.asarray(tokens(20 + T, (2, T), jcfg.vocab_size))}
    own = to_np(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def one_ulp(a):
        way = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf).astype(a.dtype)
        return np.nextafter(a, way)

    for params, lo, hi in ((own, own_min, None), (fan_in_rescaled(jm, own), None, 0.1)):
        base = np.asarray(fwd(params, batch)[0])
        moved = np.asarray(fwd(jax.tree.map(one_ulp, params), batch)[0])
        ratio = float(np.abs(moved - base).max()) / (TOL * max(1.0, float(np.abs(base).max())))
        assert lo is None or ratio >= lo, ratio
        assert hi is None or ratio < hi, ratio


@pytest.fixture(scope="module")
def zamba():
    pr = pair("zamba2-1.2b", seed=0)
    assert (pr.cfg.n_layers, pr.cfg.attn_every) == (4, 2)
    return pr


@pytest.mark.parametrize("T", [40, 200])
def test_zamba2_prefill_and_decode_against_reference(zamba, T):
    serve_both(zamba, tokens(20 + T, (2, T), zamba.cfg.vocab_size), steps=4)


def test_zamba2_forward_against_reference(zamba):
    prompt = tokens(21, (2, 40), zamba.cfg.vocab_size)
    jl, _ = jax.jit(zamba.jmodel.forward)(zamba.params, {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        pl, _ = zamba.model({"tokens": torch.from_numpy(prompt)})
    assert_close(pl, jl, "zamba2 forward logits")


def test_zamba2_greedy_tokens_equal_the_reference(zamba):
    greedy_both(zamba, tokens(22, (2, 40), zamba.cfg.vocab_size))


def test_zamba2_cache_layout(zamba):
    """The reference's cache layout: a KV cache for every layer, the SSM
    state float32 whatever the cache dtype."""
    cfg = zamba.cfg
    c = zamba.model.init_cache(3, 10, torch.bfloat16)
    jc = zamba.jmodel.init_cache(3, 10, jnp.bfloat16)
    for got, want in ((c["mamba"], jc["mamba"]), (c["kv"], jc["kv"])):
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert c["kv"].k.shape[0] == cfg.n_layers
    assert c["mamba"].state.dtype == torch.float32
    np.testing.assert_array_equal(c["mamba"].conv.float().numpy(),
                                  np.asarray(jc["mamba"].conv, np.float32))
