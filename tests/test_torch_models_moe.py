"""The port's MoE capacity path (`repro_torch.models.moe`), MLA attention
and DeepSeek-V2-Lite-16B (reduced: one dense and one MoE layer, 8
routed experts, top-2, float32) on the CPU against the JAX package, on
the same weights and inputs.

The expert FFN's grouped GEMMs: on CPU tensors the port's
`grouped_gemm` runs its plain version, held here against the
reference's Pallas grouped kernel in interpret mode (`_expert_ffn(...,
interpret=True)`) and its einsum path.  Routing is held exactly (the
same expert ids, slots and validity; ties in the top-k would be free to
order either way, and the random logits here have none).  Tolerance as
in `test_torch_models.py`: max |Δ| ≤ 1e-4·max(1, max|ref|)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.spec import init_params as jinit_params
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.library import default_library
from repro_torch.kernels.grouped_gemm import ops as ggops
from repro_torch.models import attention as attn
from repro_torch.models import moe
from tests.test_torch_models import (
    assert_close,
    assert_tree_close,
    greedy_both,
    jit_cfg,
    pair,
    port_params,
    rng_arrays,
    same_cfg,
    serve_both,
    to_np,
    tokens,
)


_jmoe_apply = jax.jit(jmoe.moe_capacity_apply, static_argnums=2,
                      static_argnames="capacity_factor")


def _moe_pair(seed: int):
    cfg, jcfg = same_cfg("deepseek-v2-lite-16b")
    jp = to_np(jinit_params(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed)))
    return cfg, jcfg, jp, port_params(moe.moe_specs(cfg), jp)


def test_route_against_reference():
    cfg, jcfg, jp, p = _moe_pair(0)
    (xt,) = rng_arrays(1, (40, cfg.d_model))
    w, ids, aux = moe._route(p, torch.from_numpy(xt), cfg)
    jw, jids, jaux = jit_cfg(jmoe._route)(jp, jnp.asarray(xt), jcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert_close(w, jw, "routing weights")
    assert_close(aux, jaux, "aux loss")


@pytest.mark.parametrize("n,groups,cap", [(40, 8, 3), (24, 64, 1), (64, 8, 100)])
def test_capacity_dispatch_is_exact(n, groups, cap):
    """Slots and validity equal the reference's, overflow copies on the
    sentinel slot groups·cap, with repeated ids (stable order)."""
    ids = np.random.default_rng(n).integers(0, groups, n, dtype=np.int32)
    slot, valid = moe._capacity_dispatch(torch.from_numpy(ids).long(), groups, cap)
    jslot, jvalid = jmoe._capacity_dispatch(jnp.asarray(ids), groups, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert int((slot == groups * cap).sum()) == int((~valid).sum())


@pytest.mark.parametrize("interpret", [None, True], ids=["einsum", "pallas-interpret"])
def test_expert_ffn_plain_against_reference(interpret):
    """The port's `_expert_ffn` (its `grouped_gemm` on CPU tensors: the
    plain version) against the reference's einsum path and its Pallas
    grouped kernel run in interpret mode at the GO tile."""
    cfg, _, jp, p = _moe_pair(2)
    E, C, D = cfg.n_routed_experts, 5, cfg.d_model
    (xbuf,) = rng_arrays(3, (E, C, D))
    got = moe._expert_ffn(p, torch.from_numpy(xbuf))
    want = jmoe._expert_ffn(jp, jnp.asarray(xbuf), interpret)
    assert_close(got, want, f"expert ffn vs reference ({interpret})")


def test_expert_ffn_calls_grouped_gemm_at_the_go_tile(monkeypatch):
    """Three grouped GEMMs, at the GO library's tiles for CD = min(16, E),
    each weight passed as it is when already in the activations' dtype."""
    cfg, _, _, p = _moe_pair(4)
    E, C = cfg.n_routed_experts, 3
    calls = []
    real = moe.grouped_gemm

    def spy(a, b, *, tile):
        calls.append((tuple(a.shape), b, tile))
        return real(a, b, tile=tile)

    monkeypatch.setattr(moe, "grouped_gemm", spy)
    moe._expert_ffn(p, torch.zeros((E, C, cfg.d_model)))
    lib = default_library()
    up = lib.tile(GemmDesc(C, cfg.moe_d_ff, cfg.d_model, dtype="f32"), min(16, E))
    dn = lib.tile(GemmDesc(C, cfg.d_model, cfg.moe_d_ff, dtype="f32"), min(16, E))
    assert [t for _, _, t in calls] == [up, up, dn]
    assert [b is w for (_, b, _), w in zip(calls, (p.wg, p.wu, p.wd))] == [True] * 3


@pytest.mark.parametrize("B,T,factor", [(2, 9, 1.25), (4, 1, 1.25), (2, 20, 0.5)])
def test_moe_capacity_apply_against_reference(B, T, factor):
    """Prefill-like and decode-like (C = 1) token counts, and a factor
    that drops copies past capacity."""
    cfg, jcfg, jp, p = _moe_pair(5)
    (x,) = rng_arrays(6, (B, T, cfg.d_model))
    y, aux = moe.moe_capacity_apply(p, torch.from_numpy(x), cfg, capacity_factor=factor)
    jy, jaux = _jmoe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=factor)
    assert_close(y, jy, f"moe y B{B} T{T} factor {factor}")
    assert_close(aux, jaux, "moe aux")


def test_moe_sentinel_rows_are_masked():
    """With every copy routed to one expert past its capacity, only C
    copies are served; the rest add nothing (their scatters land on the
    dropped sentinel row)."""
    cfg, jcfg, jp, p = _moe_pair(7)
    jp = dict(jp, router=np.zeros_like(jp["router"]))
    jp["router"][:, 0] = 1.0
    jp["router"][:, 1] = 0.5
    p.router.copy_(torch.from_numpy(jp["router"]))
    (x,) = np.abs(rng_arrays(8, (1, 12, cfg.d_model)))
    y, _ = moe.moe_capacity_apply(p, torch.from_numpy(x), cfg, capacity_factor=0.5)
    jy, _ = _jmoe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=0.5)
    assert_close(y, jy, "moe with overflow")


# ------------------------------------------------------------------- MLA
def _mla_pair(seed: int, **kw):
    cfg, jcfg = same_cfg("deepseek-v2-lite-16b", **kw)
    jp = to_np(jinit_params(jattn.mla_specs(jcfg), jax.random.PRNGKey(seed)))
    return cfg, jcfg, jp, port_params(attn.mla_specs(cfg), jp)


@pytest.mark.parametrize("kw", [{}, {"q_lora_rank": 24}], ids=str)
def test_mla_prefill_and_absorbed_decode_against_reference(kw):
    """No cache (flash attention with dv 32 ≠ dqk 48), a cached prefill
    writing the latent cache, then two absorbed decode steps."""
    cfg, jcfg, jp, p = _mla_pair(9, **kw)
    jmla = jit_cfg(jattn.mla_apply)
    B, T, S = 2, 11, 16
    x, x1, x2 = rng_arrays(10, (B, T, cfg.d_model), (B, 1, cfg.d_model),
                           (B, 1, cfg.d_model))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    y, _ = attn.mla_apply(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    jy, _ = jmla(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    assert_close(y, jy, "mla, no cache")
    cache = attn.init_mla_cache(cfg, B, S, torch.float32, "cpu")
    jcache = jattn.init_mla_cache(jcfg, B, S, jnp.float32)
    for i, xs in enumerate((x, x1, x2)):
        n = 0 if i == 0 else T + i - 1
        ps = pos if i == 0 else np.full((B, 1), n, np.int32)
        y, cache = attn.mla_apply(p, torch.from_numpy(xs), cfg, torch.from_numpy(ps),
                                  cache=cache, cache_len=n)
        jy, jcache = jmla(jp, jnp.asarray(xs), jcfg, jnp.asarray(ps),
                          cache=jcache, cache_len=jnp.int32(n))
        assert_close(y, jy, f"mla call {i}")
        assert_tree_close(cache, jcache, f"mla call {i} cache")


# ------------------------------------------------------- DeepSeek-V2-Lite
@pytest.fixture(scope="module")
def deepseek():
    pr = pair("deepseek-v2-lite-16b", seed=0)
    assert (pr.cfg.first_dense_layers, pr.cfg.n_layers) == (1, 2)
    return pr


def test_deepseek_forward_against_reference(deepseek):
    prompt = tokens(30, (2, 24), deepseek.cfg.vocab_size)
    jl, jaux = jax.jit(deepseek.jmodel.forward)(deepseek.params, {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        pl, aux = deepseek.model({"tokens": torch.from_numpy(prompt)})
    assert_close(pl, jl, "deepseek forward logits")
    assert_close(aux, jaux, "deepseek aux")


def test_deepseek_prefill_and_decode_against_reference(deepseek):
    serve_both(deepseek, tokens(31, (2, 40), deepseek.cfg.vocab_size), steps=4)


def test_deepseek_greedy_tokens_equal_the_reference(deepseek):
    greedy_both(deepseek, tokens(32, (2, 40), deepseek.cfg.vocab_size))


def test_decode_capacity_at_batch_4():
    """A decode step at batch 4 of the full-width config gives C = 1: the
    grouped GEMM takes 64 groups of one row."""
    from repro_torch.configs import get_arch
    cfg = get_arch("deepseek-v2-lite-16b")
    n, k, E = 4, cfg.moe_top_k, cfg.n_routed_experts
    assert max(int(math.ceil(n * k / E * 1.25)), 1) == 1
    assert ggops.grouped_gemm is moe.grouped_gemm
