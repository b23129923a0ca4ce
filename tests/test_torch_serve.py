"""The port's serving entry points on the CPU: `greedy_decode` with the
runtime in shadow dispatch against the JAX package's (the same planner
telemetry), the launcher `repro_torch.launch.serve.main`, `make_batch`,
the input shapes, parameter counts of the full-width models counted
without allocating, and the weight converter `from_reference`.  Every
entry point defaults to CUDA and raises without it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import shapes as jshapes
from repro.models import build_model as jbuild_model
from repro.models.spec import param_count as jparam_count
from repro.runtime import Runtime as JRuntime
from repro.train.serve_loop import greedy_decode as jgreedy_decode
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs import shapes
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import serve
from repro_torch.models import Model, build_model
from repro_torch.models.convert import from_reference
from repro_torch.runtime import Runtime
from repro_torch.train.serve_loop import greedy_decode, make_serve_fns
from tests.test_torch_models import pair, to_np, tokens

ARCHS = ["deepseek-v2-236b", "deepseek-v2-lite-16b", "gemma3-27b", "musicgen-medium",
         "pixtral-12b", "qwen2-72b", "qwen3-14b", "stablelm-3b", "xlstm-350m",
         "zamba2-1.2b"]
# planner telemetry both packages must agree on
TELEMETRY = ("submitted", "completed", "flushes", "groups", "mean_cd", "max_cd",
             "modes", "plan_cache_hit_rate", "prewarmed_plans", "graphs_submitted",
             "graphs_completed", "graph_nodes", "queue_depths")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ------------------------------------------------------ configs and counts
def test_archs_and_config_counts_match_the_reference():
    assert list_archs() == sorted(ARCHS)
    for name in ARCHS:
        for cfg, jcfg in ((get_arch(name), jget_arch(name)),
                          (get_arch(name).reduced(), jget_arch(name).reduced())):
            assert cfg.param_count() == jcfg.param_count(), cfg.name
            assert cfg.active_param_count() == jcfg.active_param_count(), cfg.name
            assert cfg.is_recurrent == jcfg.is_recurrent
            for s in jshapes.SHAPES:
                assert cfg.supports_shape(s) == jcfg.supports_shape(s)


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_parameter_count_equals_the_reference(name):
    """The full-width model on the meta device (nothing allocated): its
    parameters, and its specs, count what the reference's specs count."""
    model = Model(get_arch(name), device="meta")
    want = jparam_count(jbuild_model(jget_arch(name)).specs())
    assert model.param_count() == want
    assert sum(p.numel() for p in model.parameters()) == want
    assert all(p.device.type == "meta" for p in model.parameters())


def test_shapes_match_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.get_shape("decode_32k").seq_len == 32_768
    with pytest.raises(KeyError, match="unknown shape"):
        shapes.get_shape("prefill_1m")


# ------------------------------------------------------------- make_batch
def test_make_batch_is_counter_based():
    cfg = get_arch("qwen3-14b").reduced()
    shape = shapes.InputShape("serve", 40, 3, "prefill")
    a, b = make_batch(cfg, shape, 5), make_batch(cfg, shape, 5)
    c = make_batch(cfg, shape, 6)
    assert a["tokens"].shape == a["labels"].shape == (3, 40)
    assert a["tokens"].dtype == torch.int32
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab_size
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    d = make_batch(cfg, shapes.InputShape("short", 7, 2, "prefill"), 5)
    assert d["tokens"].shape == d["labels"].shape == (2, 7)


# ------------------------------------------------------- the serve loop
def _telemetry(rt) -> dict:
    s = rt.telemetry.summary()
    return {k: s[k] for k in TELEMETRY}


@pytest.mark.parametrize("name,mode", [("qwen3-14b", "requests"),
                                       ("deepseek-v2-lite-16b", "mixed_ops"),
                                       ("zamba2-1.2b", "graph")])
def test_greedy_decode_shadow_runtime_matches_the_reference(name, mode):
    """The same prompt through both packages' greedy loops with a runtime
    in shadow dispatch (the step's GEMM requests, its op bundle, or its
    dependency graph): equal tokens and equal planner telemetry."""
    pr = pair(name)
    prompt = tokens(40, (2, 40), pr.cfg.vocab_size)
    kw = dict(mixed_ops=mode == "mixed_ops", graph=mode == "graph")
    jrt, rt = JRuntime(), Runtime(device="cpu")
    want = jgreedy_decode(pr.jmodel, pr.params, {"tokens": jnp.asarray(prompt)},
                          s_max=45, steps=4, runtime=jrt, tenant="t", **kw)
    got = greedy_decode(pr.model, {"tokens": torch.from_numpy(prompt)}, s_max=45,
                        steps=4, runtime=rt, tenant="t", device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rt.config.execute is False
    assert _telemetry(rt) == _telemetry(jrt)
    assert rt.telemetry.summary()["groups"] > 0


def test_greedy_decode_hands_each_steps_logits_over():
    pr = pair("qwen3-14b")
    prompt = torch.from_numpy(tokens(41, (2, 9), pr.cfg.vocab_size))
    seen = []
    toks = greedy_decode(pr.model, {"tokens": prompt}, s_max=14, steps=4,
                         device="cpu", on_step=seen.append)
    assert len(seen) == 5 and all(s.shape == (2, 1, pr.cfg.vocab_size) for s in seen)
    assert torch.equal(toks, torch.cat([s[:, -1].argmax(-1, keepdim=True)
                                        for s in seen[:4]], 1))
    prefill, decode = make_serve_fns(pr.model)
    cache = pr.model.init_cache(2, 14, torch.float32)
    with torch.inference_mode():
        logits, cache, n = prefill({"tokens": prompt}, cache)
        assert torch.equal(logits, seen[0]) and n == 9
        logits, cache, n = decode(toks[:, :1], cache, n)
    assert torch.equal(logits, seen[1]) and n == 10


@pytest.mark.parametrize("name,flags", [
    ("qwen3-14b", ["--runtime", "--graph"]),
    ("deepseek-v2-lite-16b", ["--runtime", "--mixed-ops"]),
    ("zamba2-1.2b", ["--runtime", "--graph"]),
])
def test_launcher_on_the_cpu(name, flags, capsys):
    toks = serve.main(["--arch", name, "--reduced", "--batch", "2", "--prompt-len",
                       "40", "--gen", "3", "--device", "cpu", *flags])
    assert toks.shape == (2, 3) and toks.device.type == "cpu"
    out = capsys.readouterr().out
    assert "[serve] runtime telemetry:" in out
    tele = eval(out.split("[serve] runtime telemetry: ")[1].splitlines()[0])
    assert tele["completed"] == tele["submitted"] > 0 and tele["groups"] > 0
    if "--graph" in flags:
        assert tele["graphs_submitted"] == tele["graphs_completed"] == 3


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = get_arch("qwen3-14b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen3-14b", "--reduced", "--gen", "1"])
    model = build_model(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        greedy_decode(model, batch, s_max=6, steps=1)
    with pytest.raises(ValueError, match="the model is on meta"):
        greedy_decode(Model(cfg, device="meta"), batch, s_max=6, steps=1, device="cpu")


# ----------------------------------------------------------- the converter
def _reference_tree(name: str, seed: int = 0, **kw):
    cfg = dataclasses.replace(jget_arch(name).reduced(), **kw)
    jm = jbuild_model(cfg)
    return (dataclasses.replace(get_arch(name).reduced(), **kw),
            to_np(jax.jit(jm.init)(jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("name,kw", [(n, {}) for n in ARCHS] +
                         [("xlstm-350m", {"n_layers": 8})], ids=str)
def test_from_reference_unstacks_every_leaf(name, kw):
    """Layer i of a stack holds slice i of its stacked leaf (xLSTM's mLSTM
    layer j of group i slice (i, j)), unstacked leaves as they are; every
    parameter is filled; a stack of no layers (the reduced xLSTM's 2
    layers make no group) places nothing."""
    cfg, tree = _reference_tree(name, 3, **kw)
    model = from_reference(build_model(cfg, device="cpu", seed=None), tree)
    np.testing.assert_array_equal(model.embed.tok.numpy(), tree["embed"]["tok"])
    np.testing.assert_array_equal(model.final_norm.numpy(), tree["final_norm"])
    stack = tree["layers"]
    for i, layer in enumerate(model.layers):
        if cfg.family == "hybrid":
            np.testing.assert_array_equal(layer.mamba.in_proj.numpy(),
                                          stack["mamba"]["in_proj"][i])
        elif cfg.family == "ssm":
            for j, sub in enumerate(layer.mlstm):
                np.testing.assert_array_equal(sub.wq.numpy(), stack["mlstm"]["wq"][i, j])
            np.testing.assert_array_equal(layer.slstm.wr.numpy(), stack["slstm"]["wr"][i])
        else:
            np.testing.assert_array_equal(layer.attn.wo.numpy(), stack["attn"]["wo"][i])
    if cfg.family == "moe":
        np.testing.assert_array_equal(model.layers[0].moe.wg.numpy(),
                                      stack["moe"]["wg"][0])
        np.testing.assert_array_equal(model.dense_layers[0].mlp.down.numpy(),
                                      tree["dense_layers"]["mlp"]["down"][0])
    if cfg.family == "hybrid":
        np.testing.assert_array_equal(model.shared.attn.wq.numpy(),
                                      tree["shared"]["attn"]["wq"])
    # one parameter per layer slice of each leaf: its stacked dims' product
    depth = {}
    for n, _ in model.named_parameters():
        parts = n.split(".")
        depth["/".join(p for p in parts if not p.isdigit())] = sum(p.isdigit() for p in parts)
    slices = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(k.key for k in path)
        slices += int(np.prod(leaf.shape[:depth[key]])) if key in depth else leaf.size
    assert len(list(model.parameters())) == slices


def test_from_reference_refuses_what_it_cannot_place():
    cfg, tree = _reference_tree("qwen3-14b")
    fresh = lambda: build_model(cfg, device="cpu", seed=None)  # noqa: E731
    missing = {**tree, "embed": {"tok": tree["embed"]["tok"]}}
    with pytest.raises(KeyError, match="no leaf embed/head"):
        from_reference(fresh(), missing)
    extra = {**tree, "extra": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="leaf extra .* matches no parameter"):
        from_reference(fresh(), extra)
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][..., :-1]
    with pytest.raises(ValueError, match="layers/attn/wq has shape"):
        from_reference(fresh(), bad)
    deeper = jax.tree.map(lambda a: a, tree)
    deeper["layers"] = jax.tree.map(lambda a: np.concatenate([a, a[:1]]), tree["layers"])
    with pytest.raises(ValueError, match="stacks \\(3,\\) layers, the model has 2"):
        from_reference(fresh(), deeper)
