"""The port's models (`repro_torch.models`) on the CPU against the JAX
package's, on the same weights and inputs: the shared layers, GQA
attention, and dense Qwen3-14B (reduced, float32) through prefill,
teacher-forced decode steps and greedy decoding.

The reference's weights are made by its own ``init`` from a seed (for
Zamba2 alone rescaled to a better-conditioned scale: `fan_in_rescaled`
says why) and carried across by `from_reference` (numpy arrays, unstacked
into the port's layer lists); inputs are numpy arrays from a seed.  The JAX
package takes its XLA reference paths here, as its own CPU tests do;
on CPU tensors the port's kernels run their plain versions.  Tolerance:
max |Δ| ≤ 1e-4·max(1, max |reference|) per tensor; greedy tokens equal.

The helpers here (`pair`, `serve_both`, `greedy_both`, `assert_close`)
are shared with `test_torch_models_hybrid.py`, `test_torch_models_moe.py`
and `test_torch_serve.py`.
"""
import dataclasses
import functools
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import spec as jspec
from repro.models.spec import init_params as jinit_params
from repro.train.serve_loop import greedy_decode as jgreedy_decode
from repro_torch.configs import ArchConfig, get_arch
from repro_torch.models import Model, build_model
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.convert import from_reference
from repro_torch.models.spec import ParamTree, tree_params
from repro_torch.train.serve_loop import greedy_decode

TOL = 1e-4


# ------------------------------------------------------------------ helpers
def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_close(got, ref, what: str, tol: float = TOL) -> None:
    """max |got − ref| ≤ tol·max(1, max |ref|), same shape."""
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}"
    if not ref.size:
        return
    assert np.isfinite(got).all(), f"{what}: non-finite values"
    err = float(np.abs(got - ref).max())
    bound = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, f"{what}: max |Δ| {err:.3g} > {bound:.3g}"


def assert_tree_close(got, ref, what: str, tol: float = TOL) -> None:
    """Caches: dicts and NamedTuples of tensors, compared leaf by leaf."""
    if ref is None:
        assert got is None, what
    elif isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            assert_tree_close(got[k], ref[k], f"{what}/{k}", tol)
    elif isinstance(ref, tuple):
        assert type(got).__name__ == type(ref).__name__, what
        for k in ref._fields:
            assert_tree_close(getattr(got, k), getattr(ref, k), f"{what}/{k}", tol)
    else:
        assert_close(got, ref, what, tol)


def port_params(specs, tree) -> ParamTree:
    """A `ParamTree` of ``specs`` holding the numpy ``tree``'s values."""
    m = ParamTree(specs, "cpu", torch.float32)
    for path, _, p in tree_params(m, specs):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        p.copy_(torch.from_numpy(np.array(leaf)))
    return m


def same_cfg(name: str, **kw):
    """The reduced config of ``name`` in both packages (same fields)."""
    jcfg = dataclasses.replace(jget_arch(name).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(name).reduced(), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


class Pair(NamedTuple):
    cfg: ArchConfig
    jmodel: object
    params: dict
    model: Model


# Configs whose reference ``init`` tree is carried across rescaled
# (`fan_in_rescaled`; for xLSTM, whose mLSTM leaves are stacked twice, σ =
# scale/√groups, `test_torch_xlstm.py::test_xlstm_reference_scale_is_ill_conditioned`);
# every other model is held to the reference on the reference's own weights.
RESCALED = frozenset({"zamba2-1.2b", "xlstm-350m"})


def fan_in_rescaled(jmodel, params):
    """The reference's ``init`` tree with each normal matrix leaf rescaled
    from σ = scale/√shape[0] (the reference's rule, which both packages
    draw by: every layer weight of a stack gets σ = scale/√n_layers, 0.5
    at the reduced depth 4) to σ = scale/√(input width), a better-
    conditioned tree for the reduced Zamba2, not either package's init.
    At the reference's own scale the reduced Zamba2's SSD decays sum to
    |Σ dt·A| ~ 10⁴ within a chunk, where its own chunked cumsum keeps
    about 3.5 digits of each decay: a one-ulp change of its own weights
    moves its own logits by 0.9× the 1e-4 bound at a 40-token prompt and
    3–4× at 200 tokens
    (`test_torch_models_hybrid.py::test_zamba2_reference_scale_is_ill_conditioned`),
    so no f32 evaluation in another summation order can be held to 1e-4
    there; on the rescaled tree the same change moves them by 0.015×.
    Both packages get the same rescaled weights."""
    def one(spec, leaf):
        if spec.init != "normal" or leaf.ndim < 2:
            return leaf
        return leaf * np.float32(np.sqrt(leaf.shape[0] / leaf.shape[-2]))

    return jax.tree.map(one, jmodel.specs(), to_np(params),
                        is_leaf=lambda x: isinstance(x, jspec.Spec))


@functools.lru_cache(maxsize=None)
def pair(name: str, seed: int = 0, **kw) -> Pair:
    """The JAX model with its ``init`` from ``seed`` (`fan_in_rescaled` if
    ``name`` is in `RESCALED`) and the port's model holding the same
    weights (`from_reference`), both reduced, f32.  Cached: callers share
    it and change no weight."""
    cfg, jcfg = same_cfg(name, **kw)
    jm = jbuild_model(jcfg)
    params = to_np(jax.jit(jm.init)(jax.random.PRNGKey(seed)))
    if name in RESCALED:
        params = fan_in_rescaled(jm, params)
    model = from_reference(build_model(cfg, device="cpu", seed=None), params)
    return Pair(cfg, jm, jax.tree.map(jnp.asarray, params), model)


def tokens(seed: int, shape, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def serve_both(pr: Pair, prompt: np.ndarray, steps: int = 4, seed: int = 7,
               s_max: int | None = None) -> None:
    """Prefill ``prompt`` and run ``steps`` teacher-forced decode steps
    (the same random tokens fed to both) in both packages with f32
    caches: the logits after each call and the whole cache within TOL."""
    B, T = prompt.shape
    s_max = s_max or T + steps + 1
    jprefill, jdecode = jax.jit(pr.jmodel.prefill), jax.jit(pr.jmodel.decode_step)
    jcache = pr.jmodel.init_cache(B, s_max, jnp.float32)
    jl, jcache, _ = jprefill(pr.params, {"tokens": jnp.asarray(prompt)}, jcache)
    with torch.inference_mode():
        cache = pr.model.init_cache(B, s_max, torch.float32)
        pl, cache, n = pr.model.prefill({"tokens": torch.from_numpy(prompt)}, cache)
    assert n == T
    assert_close(pl, jl, f"{pr.cfg.name} prefill logits")
    assert_tree_close(cache, jcache, f"{pr.cfg.name} prefill cache")
    fed = tokens(seed, (steps, B, 1), pr.cfg.vocab_size)
    jlen = jnp.asarray(T, jnp.int32)
    for i in range(steps):
        jl, jcache, jlen = jdecode(pr.params, jnp.asarray(fed[i]), jcache, jlen)
        with torch.inference_mode():
            pl, cache, n = pr.model.decode_step(torch.from_numpy(fed[i]), cache, n)
        assert n == int(jlen)
        assert_close(pl, jl, f"{pr.cfg.name} decode step {i} logits")
        assert_tree_close(cache, jcache, f"{pr.cfg.name} decode step {i} cache")


def greedy_both(pr: Pair, prompt: np.ndarray, steps: int = 6):
    """Greedy tokens of both packages on ``prompt``; returns the port's."""
    s_max = prompt.shape[1] + steps + 1
    want = np.asarray(jgreedy_decode(pr.jmodel, pr.params,
                                     {"tokens": jnp.asarray(prompt)},
                                     s_max=s_max, steps=steps))
    got = greedy_decode(pr.model, {"tokens": torch.from_numpy(prompt)},
                        s_max=s_max, steps=steps, device="cpu")
    assert got.shape == (prompt.shape[0], steps)
    np.testing.assert_array_equal(got.numpy(), want)
    return got


def jit_cfg_at(fn, argnum: int):
    """A reference function jitted with its config (argument ``argnum``)
    static: one compile instead of op-by-op dispatch."""
    return jax.jit(fn, static_argnums=argnum)


def jit_cfg(fn):
    return jit_cfg_at(fn, 2)


def rng_arrays(seed: int, *shapes, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


# ------------------------------------------------------------ shared layers
@pytest.mark.parametrize("shape", [(2, 5, 128), (3, 1, 64)])
def test_rms_norm(shape):
    x, w = rng_arrays(0, shape, shape[-1:], scale=3.0)
    assert_close(common.rms_norm(torch.from_numpy(w), torch.from_numpy(x), 1e-6),
                 jcommon.rms_norm(jnp.asarray(w), jnp.asarray(x), 1e-6), "rms_norm")


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("D", [16, 32, 128])
def test_rope(D, theta):
    assert_close(common.rope_freqs(D, theta), jcommon.rope_freqs(D, theta), "freqs")
    (x,) = rng_arrays(1, (2, 7, 3, D))
    pos = np.array([np.arange(7), np.arange(40, 47)], np.int32)
    assert_close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
                 jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
                 "apply_rope")


def test_mlp_embed_and_head():
    d, ff, V = 32, 48, 50
    x, g, u, dn, tok, head = rng_arrays(2, (2, 3, d), (d, ff), (d, ff), (ff, d),
                                        (V, d), (d, V), scale=0.3)
    t = {k: torch.from_numpy(v) for k, v in dict(gate=g, up=u, down=dn).items()}
    assert_close(common.mlp_apply(SimpleNamespace(**t), torch.from_numpy(x)),
                 jcommon.mlp_apply(dict(gate=g, up=u, down=dn), x), "mlp")
    ids = tokens(3, (2, 4), V)
    for tied in (False, True):
        jp = {"tok": tok} if tied else {"tok": tok, "head": head}
        p = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in jp.items()})
        e = common.embed_apply(p, torch.from_numpy(ids))
        assert_close(e, jcommon.embed_apply(jp, jnp.asarray(ids)), "embed")
        assert_close(common.lm_head_apply(p, torch.from_numpy(x)),
                     jcommon.lm_head_apply(jp, x), f"lm head (tied={tied})")


def test_specs_match_the_reference():
    """Every layer's spec dict: the same keys, shapes, inits and scales."""
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks
    for name in ("qwen3-14b", "zamba2-1.2b", "deepseek-v2-lite-16b"):
        cfg, jcfg = same_cfg(name)
        pairs = [(blocks.attn_block_specs(cfg, cfg.d_ff, cfg.family == "moe"),
                  jblocks.attn_block_specs(jcfg, jcfg.d_ff, jcfg.family == "moe"))]
        if cfg.family == "hybrid":
            pairs.append((blocks.zamba_layer_specs(cfg), jblocks.zamba_layer_specs(jcfg)))
        for s, js in pairs:
            flat = {p: x for p, x in _flat(s)}
            jflat = {p: x for p, x in _flat(js)}
            assert set(flat) == set(jflat), name
            for p, x in flat.items():
                j = jflat[p]
                assert (x.shape, x.axes, x.init, x.scale) == (j.shape, j.axes,
                                                              j.init, j.scale), p


def _flat(specs, prefix=()):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ------------------------------------------------------------------- GQA
def _gqa_pair(seed: int, **kw):
    cfg, jcfg = same_cfg("qwen3-14b", **kw)
    jp = jinit_params(jattn.gqa_specs(jcfg), jax.random.PRNGKey(seed))
    jp = to_np(jp)
    if cfg.qkv_bias:   # non-zero biases, so that they count
        for k, b in zip(("bq", "bk", "bv"), rng_arrays(seed, *(jp[k].shape for k in
                                                             ("bq", "bk", "bv")))):
            jp[k] = b
    return cfg, jcfg, jp, port_params(attn.gqa_specs(cfg), jp)


@pytest.mark.parametrize("kw", [{}, {"qkv_bias": True, "qk_norm": False},
                                {"n_kv_heads": 4}], ids=str)
def test_gqa_prefill_and_decode_against_reference(kw):
    """No cache (flash attention over the prompt), a cached prefill (flash
    attention against the written cache, q_offset 0) and two decode steps
    (the einsum path over all S_max slots), the cache after each."""
    cfg, jcfg, jp, p = _gqa_pair(4, **kw)
    jgqa = jit_cfg(jattn.gqa_apply)
    B, T, S = 2, 9, 16
    (x, x1, x2) = rng_arrays(5, (B, T, cfg.d_model), (B, 1, cfg.d_model),
                             (B, 1, cfg.d_model))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    y, _ = attn.gqa_apply(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    jy, _ = jgqa(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    assert_close(y, jy, "gqa, no cache")

    cache = attn.init_kv_cache(cfg, B, S, torch.float32, "cpu")
    jcache = jattn.init_kv_cache(jcfg, B, S, jnp.float32)
    y, cache = attn.gqa_apply(p, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                              cache=cache, cache_len=0)
    jy, jcache = jgqa(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 cache=jcache, cache_len=jnp.int32(0))
    assert_close(y, jy, "gqa prefill")
    assert_tree_close(cache, jcache, "gqa prefill cache")
    for i, xs in enumerate((x1, x2)):
        n = T + i
        pos1 = np.full((B, 1), n, np.int32)
        y, cache = attn.gqa_apply(p, torch.from_numpy(xs), cfg, torch.from_numpy(pos1),
                                  cache=cache, cache_len=n)
        jy, jcache = jgqa(jp, jnp.asarray(xs), jcfg, jnp.asarray(pos1),
                                     cache=jcache, cache_len=jnp.int32(n))
        assert_close(y, jy, f"gqa decode {i}")
        assert_tree_close(cache, jcache, f"gqa decode {i} cache")


def test_attend_cache_with_bf16_cache():
    """The decode path on a bf16 cache: q rounded to the cache's dtype,
    f32 scores, probabilities rounded before the value product — as the
    reference's `_attend_cache`, on the same bf16 values."""
    B, T, Hq, Hkv, hd, S = 2, 1, 8, 2, 16, 12
    q, k, v = rng_arrays(6, (B, T, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))
    kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    pos = np.full((B, T), 7, np.int32)
    got = attn._attend_cache(torch.from_numpy(q), kb, vb, q_pos=torch.from_numpy(pos),
                             length=8)
    want = jattn._attend_cache(jnp.asarray(q), jnp.asarray(k).astype(jnp.bfloat16),
                               jnp.asarray(v).astype(jnp.bfloat16),
                               q_pos=jnp.asarray(pos), length=8, window=0)
    assert got.dtype == torch.float32
    assert_close(got, want, "attend_cache bf16", tol=2e-3)


def test_attention_cache_is_written_in_place():
    """A cached call writes into the given buffers at cache_len and
    returns them (no fresh tensor per step)."""
    cfg, _, _, p = _gqa_pair(8)
    cache = attn.init_kv_cache(cfg, 1, 8, torch.float32, "cpu")
    ptrs = (cache.k.data_ptr(), cache.v.data_ptr())
    (x,) = rng_arrays(9, (1, 1, cfg.d_model))
    _, out = attn.gqa_apply(p, torch.from_numpy(x), cfg, torch.full((1, 1), 3),
                            cache=cache, cache_len=3)
    assert (out.k.data_ptr(), out.v.data_ptr()) == ptrs
    assert out.k[:, 3].abs().sum() > 0 and out.k[:, :3].abs().sum() == 0
    assert out.k[:, 4:].abs().sum() == 0


# ------------------------------------------------------------ Qwen3-14B
@pytest.fixture(scope="module")
def qwen():
    return pair("qwen3-14b", seed=0)


def test_qwen3_forward_against_reference(qwen):
    prompt = tokens(10, (2, 24), qwen.cfg.vocab_size)
    jl, jaux = jax.jit(qwen.jmodel.forward)(qwen.params, {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        pl, aux = qwen.model({"tokens": torch.from_numpy(prompt)})
    assert_close(pl, jl, "qwen3 forward logits")
    assert float(aux) == float(jaux) == 0.0


def test_qwen3_prefill_and_decode_against_reference(qwen):
    serve_both(qwen, tokens(11, (2, 40), qwen.cfg.vocab_size), steps=4)


def test_qwen3_greedy_tokens_equal_the_reference(qwen):
    greedy_both(qwen, tokens(12, (2, 40), qwen.cfg.vocab_size))


# -------------------------------------------------------------- build_model
def test_build_model_initialises_from_a_generator():
    """Weights from ``seed`` by a torch.Generator: equal seeds equal
    weights; normals truncated at ±2σ with σ = scale/√fan_in, the
    reference's rule: shape[0] of the leaf as the reference declares it,
    so n_layers for a layer weight of a stack; norms ones, biases zeros."""
    cfg = get_arch("qwen3-14b").reduced()
    a = build_model(cfg, device="cpu", seed=3)
    b = build_model(cfg, device="cpu", seed=3)
    c = build_model(cfg, device="cpu", seed=4)
    for (n, x), y, z in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(x, y), n
        assert torch.isfinite(x).all(), n
    assert not torch.equal(a.layers[0].attn.wq, c.layers[0].attn.wq)
    wq = a.layers[1].attn.wq
    sigma = 1.0 / np.sqrt(cfg.n_layers)
    assert float(wq.abs().max()) <= 2 * sigma
    assert 0.75 * sigma < float(wq.std()) < 0.95 * sigma   # truncated: ≈ 0.88σ
    down = a.layers[0].mlp.down
    assert float(down.abs().max()) <= 2 * 0.5 / np.sqrt(cfg.n_layers)
    assert torch.equal(a.layers[0].attn_norm, torch.ones(cfg.d_model))
    assert torch.equal(a.final_norm, torch.ones(cfg.d_model))


def test_unported_options_raise():
    """Expert parallelism builds (``moe_mode="ep"``, `tests/test_torch_tp.py`);
    the hybrid and ssm families on a model axis above 1 are ROADMAP A13d,
    and raise naming it; an unknown mode raises; remat and
    ``cache_pspecs`` are ported (`tests/test_torch_remat.py`,
    `tests/test_torch_dist.py`)."""
    from repro_torch.launch.mesh import MeshShape

    cfg = get_arch("qwen3-14b").reduced()
    assert Model(cfg, device="meta", moe_mode="ep").moe_mode == "ep"
    with pytest.raises(ValueError, match="moe_mode"):
        Model(cfg, device="meta", moe_mode="dense")
    for name in ("zamba2-1.2b", "xlstm-350m"):
        with pytest.raises(NotImplementedError, match="A13d"):
            Model(get_arch(name).reduced(), device="meta",
                  mesh=MeshShape(data=1, model=2), rank=0)
