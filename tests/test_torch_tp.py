"""Serving on the model axis (`repro_torch.dist.tp`, `Model(mesh=...)`,
`launch.serve` over ranks) on the CPU: each rank a spawned process on a
(1, M) mesh over gloo (`tests/torch_dist_workers.py:tp_serve`), held to
the JAX package's same functions on `make_debug_mesh(1, M)` over the
four forced host devices (`tests/conftest.py`), its parameters placed by
``named(params_pspecs)``, at M = 2 and 4, in f32 on reduced configs.

- The modules, on the reference's weights (`from_reference` into each
  rank's shard): GQA without a cache, prefilling a cache and one decode
  step (the rank's cache against its heads of the reference's); MLA the
  same (its latent cache whole on every rank); the MLP; the untied table
  (cut over d) and head (cut over the vocabulary) and the tied table
  (cut over the vocabulary); the routed experts over `all_to_all`
  against `moe_ep_apply`, and the capacity path with the experts cut
  against `moe_capacity_apply`, each at capacity factor 1.25 and at
  0.25, which drops copies.
- A config whose KV heads M does not divide (reduced Qwen3-14B's 2 KV
  heads at M = 4): its attention is whole on every rank, its cache too,
  and it gives the same function.
- Reduced Qwen3-14B and DeepSeek-V2-Lite-16B through `greedy_decode`:
  the reference's greedy tokens exactly, on every rank, and the prefill's
  logits within TOL; DeepSeek's prefill takes the EP path and its decode
  steps the sharded capacity path.
- Each rank's seeded shard (`build_model(mesh=..., seed=0)`), put
  together by its layout, equals the one-rank model's leaves bitwise;
  so do shards built with no ranks (`rank=`), for every config here.
- `launch.serve --device cpu` on 2 ranks gives world 1's tokens.

Tolerance TOL = 1e-4·max(1, max |reference|), as
`tests/test_torch_models.py`: GSPMD and the ranks sum the cut products
in other orders than one device.  The EP path moves activations in
bf16, as the reference's; the port rounds as XLA does on the CPU (the
sigmoid op by op, the combine's adds one at a time in bf16), so it is
held to the same bound.  One spawn per M runs every case; each test
reads its part.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.sharding import named as jnamed
from repro.dist.sharding import params_pspecs as jparams_pspecs
from repro.launch.mesh import make_debug_mesh as jmesh
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.train.serve_loop import greedy_decode as jgreedy_decode
from repro_torch.configs import get_arch
from repro_torch.dist import tp
from repro_torch.dist.sharding import LeafLayout, shard_leaf, tp_layouts
from repro_torch.launch.mesh import MeshShape, shared_card
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import Model, build_model
from test_torch_models import TOL, assert_close, pair, to_np
from torch_dist_workers import spawn_join, spawn_start

B, T, STEPS = 2, 16, 5
TM = 32            # the MoE inputs' length: 16 tokens a rank at M = 2, 8 at M = 4
CFS = (1.25, 0.25)
WORLDS = (2, 4)
SERVE_ARGV = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu", "--batch", "2",
              "--prompt-len", "8", "--gen", "4"]
# case → (arch, config overrides, checks)
CASES = {
    "qwen3": ("qwen3-14b", {}, ("attn", "mlp", "vocab", "greedy")),
    "qwen3-8x4-heads": ("qwen3-14b", {"n_heads": 8, "n_kv_heads": 4}, ("attn",)),
    "qwen3-tied": ("qwen3-14b", {"tie_embeddings": True}, ("vocab",)),
    "deepseek": ("deepseek-v2-lite-16b", {}, ("attn", "mlp", "vocab", "moe", "greedy")),
}


def _rng(seed: int):
    return np.random.default_rng(seed)


def _inputs(key: str) -> dict:
    arch, kw, checks = CASES[key]
    pr = pair(arch, **kw)
    cfg, rng = pr.cfg, _rng(11)
    return {"arch": arch, "kw": kw, "checks": checks, "params": to_np(pr.params),
            "x": rng.standard_normal((B, T, cfg.d_model), np.float32),
            "xm": rng.standard_normal((B, TM, cfg.d_model), np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32),
            "prompt": rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32),
            "steps": STEPS, "cfs": CFS}


def _first_layer(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _reference(key: str, case: dict, M: int) -> dict:
    """The JAX package's outputs for ``case`` on `make_debug_mesh(1, M)`,
    its parameters placed by ``named(params_pspecs)``."""
    arch, kw, checks = CASES[key]
    pr = pair(arch, **kw)
    jcfg = pr.jmodel.cfg
    mesh = jmesh(1, M)
    jm = jbuild_model(jcfg, mesh=mesh)
    params = jax.device_put(pr.params, jnamed(mesh, jparams_pspecs(jm, mesh)))
    x, xm = jnp.asarray(case["x"]), jnp.asarray(case["xm"])
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    ref = {}

    @jax.jit
    def modules(P):
        out = {}
        if "attn" in checks:
            p = _first_layer(P["layers"])["attn"]
            if jcfg.attn_type == "mla":
                apply, cache = jattn.mla_apply, jattn.init_mla_cache(jcfg, B, T + 2,
                                                                    jnp.float32)
            else:
                apply, cache = jattn.gqa_apply, jattn.init_kv_cache(jcfg, B, T + 2,
                                                                   jnp.float32)
            y0, _ = apply(p, x, jcfg, pos, mesh=mesh)
            y1, cache = apply(p, x, jcfg, pos, cache=cache,
                              cache_len=jnp.zeros((), jnp.int32), mesh=mesh)
            y2, cache = apply(p, x[:, :1], jcfg, pos[:, :1] + T, cache=cache,
                              cache_len=jnp.asarray(T, jnp.int32), mesh=mesh)
            out["attn"] = {"prefill": y0, "cached prefill": y1, "decode step": y2,
                           "cache": tuple(cache)}
        if "mlp" in checks:
            stack = P["dense_layers"] if jcfg.family == "moe" else P["layers"]
            out["mlp"] = jcommon.mlp_apply(_first_layer(stack)["mlp"], x)
        if "vocab" in checks:
            out["embed"] = jcommon.embed_apply(P["embed"], jnp.asarray(case["tokens"]))
            out["head"] = jcommon.lm_head_apply(P["embed"], x)
        if "moe" in checks:
            p = _first_layer(P["layers"])["moe"]
            out["ep"] = {cf: jmoe.moe_ep_apply(p, xm, jcfg, mesh, capacity_factor=cf)
                         for cf in CFS}
            out["capacity"] = {cf: jmoe.moe_capacity_apply(p, xm, jcfg, capacity_factor=cf)
                               for cf in CFS}
        return out

    ref.update(to_np(modules(params)))
    if "greedy" in checks:
        prompt = {"tokens": jnp.asarray(case["prompt"])}
        ref["tokens"] = np.asarray(jgreedy_decode(jm, params, prompt, s_max=T + STEPS + 1,
                                                  steps=STEPS))
        cache = jm.init_cache(B, T + STEPS + 1, jnp.float32)
        ref["prefill logits"] = np.asarray(jax.jit(jm.prefill)(params, prompt, cache)[0])
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """M → (the ranks' results, the references, the inputs) for every
    case: one spawn of M ranks, the references computed while they run."""
    done = {}

    def run(M: int):
        if M not in done:
            tmp = tmp_path_factory.mktemp(f"tp{M}")
            cases = {key: _inputs(key) for key in CASES}
            torch.save({"cases": cases, "serve": [SERVE_ARGV] if M == 2 else []},
                       tmp / "in.pt")
            started = spawn_start(tmp, M, "tp_serve", inputs=str(tmp / "in.pt"))
            refs = {key: _reference(key, case, M) for key, case in cases.items()}
            done[M] = spawn_join(started), refs, cases
        return done[M]
    return run


@pytest.fixture(params=WORLDS, ids=lambda m: f"M{m}")
def world(request):
    return request.param


def _cfg(key: str):
    arch, kw, _ = CASES[key]
    return dataclasses.replace(get_arch(arch).reduced(), **kw)


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("key", ["qwen3", "qwen3-8x4-heads", "deepseek"])
def test_attention_matches_the_reference_on_the_mesh(runs, world, key):
    ranks, refs, _ = runs(world)
    cfg, ref = _cfg(key), refs[key]["attn"]
    for res in ranks:
        got = res[key]["attn"]
        for what in ("prefill", "cached prefill", "decode step"):
            assert_close(got[what], ref[what], f"{key} M{world} rank {res[key]['rank']} "
                         f"{what}")
        for i, (c, want) in enumerate(zip(got["cache"], ref["cache"])):
            if cfg.attn_type != "mla" and c.shape[2] < want.shape[2]:
                want = shard_leaf(want, LeafLayout(2, world), res[key]["rank"])
            assert_close(c, want, f"{key} M{world} cache {i}")


@pytest.mark.parametrize("key,world_", [("qwen3", 2), ("qwen3", 4),
                                         ("qwen3-8x4-heads", 2), ("qwen3-8x4-heads", 4),
                                         ("deepseek", 2), ("deepseek", 4)])
def test_attention_is_cut_exactly_where_the_heads_divide(runs, key, world_):
    """Reduced Qwen3-14B's 2 KV heads at M = 4: its attention and cache
    are whole on every rank; everywhere else each rank holds 1/M of the
    heads and of the GQA cache, and MLA's latent cache stays whole."""
    ranks, _, _ = runs(world_)
    cfg = _cfg(key)
    cut = (cfg.n_heads % world_ == 0 if cfg.attn_type == "mla" else
           cfg.n_kv_heads % world_ == 0)
    for res in ranks:
        lay = {n: d for n, (d, _) in res[key]["layouts"].items() if ".attn." in n}
        assert lay and all((d is not None) == (cut and not n.endswith("norm") and
                                               "wdkv" not in n and "wdq" not in n)
                           for n, d in lay.items()), lay
        heads = res[key]["attn"]["cache"][0].shape[2]
        if cfg.attn_type != "mla":
            assert heads == cfg.n_kv_heads // (world_ if cut else 1)
        else:
            assert heads == cfg.kv_lora_rank


@pytest.mark.parametrize("key", ["qwen3", "deepseek"])
def test_mlp_matches_the_reference_on_the_mesh(runs, world, key):
    ranks, refs, _ = runs(world)
    for res in ranks:
        assert_close(res[key]["mlp"], refs[key]["mlp"], f"{key} M{world} mlp")


@pytest.mark.parametrize("key", ["qwen3", "qwen3-tied", "deepseek"])
@pytest.mark.parametrize("what", ["embed", "head"])
def test_table_and_head_match_the_reference_on_the_mesh(runs, world, key, what):
    ranks, refs, _ = runs(world)
    for res in ranks:
        assert_close(res[key][what], refs[key][what], f"{key} M{world} {what}")


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("path", ["ep", "capacity"])
def test_routed_experts_match_the_reference_on_the_mesh(runs, world, path, cf):
    """EP against `moe_ep_apply`, the cut capacity path against
    `moe_capacity_apply`: outputs and aux loss on every rank."""
    ranks, refs, _ = runs(world)
    y_ref, aux_ref = refs["deepseek"][path][cf]
    for res in ranks:
        y, aux = res["deepseek"][path][cf]
        assert_close(y, y_ref, f"{path} cf {cf} M{world} rank {res['deepseek']['rank']}")
        assert_close(aux, aux_ref, f"{path} cf {cf} aux")


@pytest.mark.parametrize("path", ["ep", "capacity"])
def test_small_capacity_factor_drops_copies(runs, world, path):
    """Capacity factor 0.25 drops copies in the reference (its output
    moves), so the drops are held too."""
    _, refs, _ = runs(world)
    full, small = (refs["deepseek"][path][cf][0] for cf in CFS)
    assert np.abs(full - small).max() > 1e-2


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("key", ["qwen3", "deepseek"])
def test_greedy_decode_gives_the_references_tokens(runs, world, key):
    ranks, refs, _ = runs(world)
    for res in ranks:
        got = res[key]["greedy"]
        np.testing.assert_array_equal(got["tokens"].numpy(), refs[key]["tokens"])
        assert_close(got["logits"][0], refs[key]["prefill logits"],
                     f"{key} M{world} prefill logits")


def test_every_rank_decodes_the_same_logits(runs, world):
    ranks, _, _ = runs(world)
    for key in ("qwen3", "deepseek"):
        first = ranks[0][key]["greedy"]["logits"]
        for res in ranks[1:]:
            for a, b in zip(first, res[key]["greedy"]["logits"]):
                assert torch.equal(a, b), key


def test_deepseek_prefill_takes_ep_and_decode_the_cut_capacity_path(runs, world):
    """The reference's choice (`repro/models/blocks.py:85-97`): EP where
    the axis divides the length (the 16-token prefill), the capacity path
    with the experts cut in the decode steps."""
    ranks, _, _ = runs(world)
    cfg = _cfg("deepseek")
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    for res in ranks:
        assert res["deepseek"]["greedy"]["paths"] == {
            "ep": moe_layers, "sharded_capacity": moe_layers * STEPS}


def test_serve_launcher_on_two_ranks_gives_world_ones_tokens(runs):
    ranks, _, _ = runs(2)
    one = serve_main(SERVE_ARGV)
    for res in ranks:
        (toks,) = res["serve"]
        assert torch.equal(toks, one)


# ------------------------------------------------------------- shards
def test_ranks_seeded_shards_are_the_one_rank_leaves(runs, world):
    ranks, _, _ = runs(world)
    for key in CASES:
        one = dict(build_model(_cfg(key), device="cpu", seed=0).named_parameters())
        for name, p in one.items():
            dim, parts = ranks[0][key]["layouts"][name]
            held = [res[key]["seeded"][name] for res in ranks]
            whole = held[0] if dim is None else torch.cat(held, dim)
            assert torch.equal(whole, p), f"{key} M{world} {name}"
            assert dim is not None or all(torch.equal(h, p) for h in held), name


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-14b", {}), ("qwen3-14b", {"tie_embeddings": True}),
    ("deepseek-v2-lite-16b", {}), ("stablelm-3b", {}), ("gemma3-27b", {}),
    ("qwen2-72b", {}), ("deepseek-v2-236b", {}), ("pixtral-12b", {})])
@pytest.mark.parametrize("M", [2, 4])
def test_planned_shards_are_the_one_rank_leaves(arch, kw, M):
    """Shards built with no ranks (`Model(rank=)`) put together by their
    layout are the one-rank model's leaves, bitwise, and each holds 1/M
    of every cut leaf."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    one = dict(build_model(cfg, device="cpu", seed=0).named_parameters())
    mesh = MeshShape(data=1, model=M)
    shards = [build_model(cfg, device="cpu", seed=0, mesh=mesh, rank=r) for r in range(M)]
    for name, p in one.items():
        lay = shards[0].layouts[name]
        held = [dict(s.named_parameters())[name] for s in shards]
        assert all(h.numel() * lay.parts == p.numel() for h in held), name
        whole = held[0] if lay.dim is None else torch.cat(held, lay.dim)
        assert torch.equal(whole, p), name


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v2-lite-16b", "qwen2-72b",
                                  "gemma3-27b"])
@pytest.mark.parametrize("M", [2, 4, 16])
def test_layouts_follow_params_pspecs_but_whole_heads(arch, M):
    """Full-width layouts: every leaf cut where `params_pspecs` puts the
    model axis, but an attention module whose heads M does not divide,
    which is whole (Qwen3-14B's 40 heads at M = 16, 2.5 a shard in the
    reference)."""
    from repro_torch.dist.sharding import attention_cut, params_pspecs

    cfg = get_arch(arch)
    model = Model(cfg, device="meta")
    mesh = MeshShape(data=1, model=M)
    lays, pspecs = tp_layouts(model, mesh), params_pspecs(model, mesh)
    for name, lay in lays.items():
        path = [k for k in name.split(".") if not k.isdigit()]
        pspec = pspecs
        for k in path:
            pspec = pspec[k]
        depth = len(name.split(".")) - len(path)
        cut = [i - depth for i, e in enumerate(pspec) if e == "model"]
        if "attn" in path and not attention_cut(cfg, M):
            assert lay.dim is None, name
        else:
            assert lay == (LeafLayout(cut[0], M) if cut else LeafLayout()), name
    attn = [n for n in lays if ".attn.w" in n]
    assert any(lays[n].dim is not None for n in attn) == attention_cut(cfg, M)


# -------------------------------------------------------- refusals, rules
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_hybrid_and_ssm_families_refuse_a_model_axis(arch):
    cfg = get_arch(arch).reduced()
    with pytest.raises(NotImplementedError, match="A13d"):
        Model(cfg, device="meta", mesh=MeshShape(data=1, model=2), rank=0)
    Model(cfg, device="meta", mesh=MeshShape(data=2, model=1))


def test_training_on_the_model_axis_raises_naming_a13c():
    with pytest.raises(NotImplementedError, match="A13c"):
        Model(get_arch("qwen3-14b").reduced(), device="meta", requires_grad=True,
              mesh=MeshShape(data=1, model=2), rank=1)


def test_a_shard_without_ranks_refuses_collectives():
    axis = tp.ModelAxis.plan(MeshShape(data=1, model=2), 1)
    x = torch.ones(4, 3)
    with pytest.raises(RuntimeError, match="no process group"):
        tp.all_reduce_sum(x, axis)
    with pytest.raises(ValueError, match="DeviceMesh"):
        tp.ModelAxis.of(MeshShape(data=1, model=2))
    with pytest.raises(ValueError, match="rank 2"):
        tp.ModelAxis.plan(MeshShape(data=1, model=2), 2)


def test_collectives_on_one_rank_return_their_input():
    axis, x = tp.ModelAxis.of(None), torch.randn(4, 6)
    assert tp.ModelAxis.of(MeshShape(data=4, model=1)) == axis
    for out in (tp.all_reduce_sum(x, axis), tp.all_gather(x, 1, axis),
                tp.all_to_all(x, axis)):
        assert out is x


def test_ep_refuses_uncut_experts_and_an_indivisible_length():
    from repro_torch.models import moe

    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    p = model.layers[0].moe
    with pytest.raises(ValueError, match="experts"):
        moe.moe_ep_apply(p, torch.zeros(1, 4, cfg.d_model), cfg,
                         tp.ModelAxis.plan(MeshShape(data=1, model=2), 0))
    y, _ = moe.moe_ep_apply(p, torch.zeros(1, 3, cfg.d_model), cfg, tp.ModelAxis())
    assert y.shape == (1, 3, cfg.d_model)


def test_shared_card_names_two_ranks_on_one_card():
    assert shared_card([("h", 0), ("h", 1), ("g", 0)]) is None
    assert shared_card([("h", 0), ("h", 1), ("h", 0)]) == (0, 2, ("h", 0))
