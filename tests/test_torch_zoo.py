"""The rest of the model zoo on the CPU against the JAX package: the seven
architectures ported last (StableLM-3B, Qwen2-72B, DeepSeek-V2-236B,
Gemma3-27B, xLSTM-350M, MusicGen-medium, Pixtral-12B), on the same
weights and inputs.

- Configs: every field of all ten registered architectures, and their
  reduced configs.
- Specs: every leaf of the port's specs against the reference's declared
  (stacked) leaf, at full width and reduced: shape under the stacked
  axes, init and scale, `Spec.fan_in` the reference's shape[0] (the outer
  stack's size for xLSTM's mLSTM leaves, stacked twice) and `Spec.ndim`
  the declared leaf's dims (both stacked axes counted).
- Models: forward logits, then prefill and 3 teacher-forced decode steps
  (logits and every cache) within the tolerance of `test_torch_models.py`
  (1e-4·max(1, max |reference|)), reduced widths; xLSTM at 8 layers (2
  groups: the reduced 2 layers hold none) on the rescaled tree
  (`fan_in_rescaled`), Gemma3 at 12 (its reduced 2 layers are both
  local; layers 5 and 11 are global) with an 80-token prompt past its
  reduced 64-token window; MusicGen on frames, its decode step on one
  frame; Pixtral on 256 patches in front of its tokens, and its loss on
  the text tail.
- The launcher and `greedy_decode` on every new architecture (MusicGen
  refused with the reason), `make_batch`'s frontends and `input_specs`
  against the reference's.

The reference's weights come from its own ``init`` and are carried
across by `from_reference`; it takes its XLA paths here (its scan's
chunked reference, its attention's reference), as its own CPU tests do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.data import pipeline
from repro_torch.launch import serve
from repro_torch.models import Model, build_model
from repro_torch.models.spec import iter_specs
from repro_torch.train.serve_loop import greedy_decode
from tests.test_torch_models import assert_close, assert_tree_close, greedy_both, pair, tokens

NEW = ["stablelm-3b", "qwen2-72b", "deepseek-v2-236b", "gemma3-27b", "xlstm-350m",
       "musicgen-medium", "pixtral-12b"]
# depths that reach each reduced model's structure
DEPTH = {"xlstm-350m": {"n_layers": 8}, "gemma3-27b": {"n_layers": 12}}
PATCHES = 256


# ---------------------------------------------------------------- configs
def test_every_registered_config_equals_the_reference():
    assert list_archs() == jlist_archs()
    for name in list_archs():
        for cfg, jcfg in ((get_arch(name), jget_arch(name)),
                          (get_arch(name).reduced(), jget_arch(name).reduced())):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), cfg.name
            assert cfg.resolved_head_dim == jcfg.resolved_head_dim


# ------------------------------------------------------------------ specs
def _declared(jspecs, path):
    leaf = jspecs
    for k in path:
        if not isinstance(k, int):
            leaf = leaf[k]
    return leaf


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NEW)
def test_spec_leaves_fan_in_and_ndim_are_the_declared_leaves(name, reduced):
    """Each port leaf against the reference leaf it is a slice of: the shape
    under its stacked axes, init and scale; `fan_in` shape[0] of the
    declared leaf (as the reference's init reads it) and `ndim` its dims
    (as the reference's training step casts and decays by them)."""
    kw = DEPTH.get(name, {}) if reduced else {}
    cfg = dataclasses.replace(get_arch(name).reduced() if reduced else get_arch(name), **kw)
    jcfg = dataclasses.replace(jget_arch(name).reduced() if reduced else jget_arch(name),
                               **kw)
    jspecs = jbuild_model(jcfg).specs()
    twice = 0
    for path, spec in iter_specs(Model(cfg, device="meta").specs()):
        ref = _declared(jspecs, path)
        index = [k for k in path if isinstance(k, int)]
        assert ref.shape[len(index):] == spec.shape, path
        assert spec.stacked == len(index), path
        assert (ref.init, ref.scale) == (spec.init, spec.scale), path
        assert spec.fan_in == (ref.shape[0] if len(ref.shape) > 1 else ref.size), path
        assert spec.ndim == len(ref.shape), path
        twice += spec.stacked == 2
    if cfg.family == "ssm" and cfg.n_layers >= cfg.slstm_every:
        assert twice == len(Model(cfg, device="meta").layers) * (cfg.slstm_every - 1) * 11


def test_xlstm_init_draws_by_the_outer_stack():
    """An mLSTM weight of xLSTM (stacked (groups, k−1, ...) in the
    reference) is drawn with σ = scale/√groups, the reference's rule."""
    cfg = dataclasses.replace(get_arch("xlstm-350m").reduced(), n_layers=16)
    m = build_model(cfg, device="cpu", seed=2)
    wq = m.layers[1].mlstm[2].wq
    sigma = 1.0 / np.sqrt(cfg.n_layers // cfg.slstm_every)
    assert float(wq.abs().max()) <= 2 * sigma
    assert 0.8 * sigma < float(wq.std()) < 0.95 * sigma


# ----------------------------------------------------------------- models
def _inputs(cfg, T: int, seed: int) -> dict:
    """Numpy inputs of T positions for both packages: tokens; MusicGen's
    frames; Pixtral's patches in front of T − 256 tokens."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": (0.1 * rng.standard_normal((2, T, cfg.d_model))).astype(np.float32)}
    if cfg.frontend == "vision_patches":
        return {"patches": (0.1 * rng.standard_normal((2, PATCHES, cfg.d_model))
                            ).astype(np.float32),
                "tokens": tokens(seed, (2, T - PATCHES), cfg.vocab_size)}
    return {"tokens": tokens(seed, (2, T), cfg.vocab_size)}


def _step_inputs(cfg, steps: int, seed: int) -> list:
    """Each decode step's input: a token (B, 1), or MusicGen's frame (B, 1, D)."""
    if cfg.frontend == "audio_frames":
        rng = np.random.default_rng(seed)
        return [(0.1 * rng.standard_normal((2, 1, cfg.d_model))).astype(np.float32)
                for _ in range(steps)]
    return list(tokens(seed, (steps, 2, 1), cfg.vocab_size))


@pytest.fixture(scope="module", params=NEW)
def zoo(request):
    return pair(request.param, 0, **DEPTH.get(request.param, {}))


def test_forward_matches_the_reference(zoo):
    T = PATCHES + 24 if zoo.cfg.frontend == "vision_patches" else 24
    batch = _inputs(zoo.cfg, T, 10)
    jl, jaux = jax.jit(zoo.jmodel.forward)(zoo.params, jax.tree.map(jnp.asarray, batch))
    with torch.inference_mode():
        pl, aux = zoo.model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert_close(pl, jl, f"{zoo.cfg.name} forward logits")
    assert_close(aux, jaux, f"{zoo.cfg.name} aux")


def test_prefill_and_decode_match_the_reference(zoo):
    """Prefill (80 positions: past Gemma3's reduced window; Pixtral's 256
    patches and 80 tokens), then 3 teacher-forced decode steps; logits and
    the whole cache after each call."""
    cfg = zoo.cfg
    T = PATCHES + 80 if cfg.frontend == "vision_patches" else 80
    batch, fed = _inputs(cfg, T, 11), _step_inputs(cfg, 3, 12)
    s_max = T + 4
    jprefill, jdecode = jax.jit(zoo.jmodel.prefill), jax.jit(zoo.jmodel.decode_step)
    jcache = zoo.jmodel.init_cache(2, s_max, jnp.float32)
    jl, jcache, jn = jprefill(zoo.params, jax.tree.map(jnp.asarray, batch), jcache)
    with torch.inference_mode():
        cache = zoo.model.init_cache(2, s_max, torch.float32)
        pl, cache, n = zoo.model.prefill({k: torch.from_numpy(v) for k, v in batch.items()},
                                         cache)
    assert n == T == int(jn)
    assert_close(pl, jl, f"{cfg.name} prefill logits")
    assert_tree_close(cache, jcache, f"{cfg.name} prefill cache")
    jlen = jnp.asarray(T, jnp.int32)
    for i, x in enumerate(fed):
        jl, jcache, jlen = jdecode(zoo.params, jnp.asarray(x), jcache, jlen)
        with torch.inference_mode():
            pl, cache, n = zoo.model.decode_step(torch.from_numpy(x), cache, n)
        assert n == int(jlen)
        assert_close(pl, jl, f"{cfg.name} decode step {i} logits")
        assert_tree_close(cache, jcache, f"{cfg.name} decode step {i} cache")


def test_gemma3_window_pattern_is_the_references():
    """Layer i is global (window 0) when i % 6 == 5, local (the sliding
    window) otherwise; a model without a ratio windows every layer."""
    m = Model(get_arch("gemma3-27b"), device="meta")
    assert [m.window(i) for i in range(12)] == [1024] * 5 + [0] + [1024] * 5 + [0]
    assert sum(m.window(i) == 0 for i in range(62)) == 10
    plain = Model(dataclasses.replace(get_arch("qwen3-14b"), n_layers=2), device="meta")
    assert [plain.window(i) for i in range(2)] == [0, 0]
    slide = dataclasses.replace(get_arch("gemma3-27b").reduced(), local_global_ratio=0)
    assert Model(slide, device="meta").window(5) == 64


def test_pixtral_loss_aligns_labels_to_the_text_tail():
    pr = pair("pixtral-12b", 0)
    batch = _inputs(pr.cfg, PATCHES + 20, 13)
    batch["labels"] = tokens(14, (2, 20), pr.cfg.vocab_size)
    jloss, jparts = jax.jit(pr.jmodel.loss)(pr.params, jax.tree.map(jnp.asarray, batch))
    with torch.inference_mode():
        loss, parts = pr.model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert_close(loss, jloss, "pixtral loss")
    assert_close(parts["ce"], jparts["ce"], "pixtral ce")


def test_musicgen_frames_cast_to_the_models_dtype():
    """bf16 frames (`make_batch`'s default) into an f32 model: cast once at
    the stack's input, the same logits as the same frames given in f32."""
    pr = pair("musicgen-medium", 0)
    frames = torch.from_numpy(_inputs(pr.cfg, 12, 15)["frames"]).bfloat16()
    with torch.inference_mode():
        a, _ = pr.model({"frames": frames})
        b, _ = pr.model({"frames": frames.float()})
    assert a.dtype == torch.float32 and torch.equal(a, b)


# --------------------------------------------------------- serving entry
@pytest.mark.parametrize("name", ["stablelm-3b", "qwen2-72b", "deepseek-v2-236b",
                                  "gemma3-27b", "xlstm-350m"])
def test_greedy_tokens_equal_the_references(name):
    """The token models through both packages' greedy loops (the
    reference's feeds tokens alone: its loop runs neither stub)."""
    pr = pair(name, 0, **DEPTH.get(name, {}))
    greedy_both(pr, tokens(16, (2, 70), pr.cfg.vocab_size), steps=4)


def test_greedy_decode_refuses_the_audio_stub():
    pr = pair("musicgen-medium", 0)
    with pytest.raises(ValueError, match="frame"):
        greedy_decode(pr.model, {"frames": torch.zeros((2, 4, pr.cfg.d_model))},
                      s_max=8, steps=2, device="cpu")


@pytest.mark.parametrize("name", ["stablelm-3b", "gemma3-27b", "xlstm-350m",
                                  "pixtral-12b", "deepseek-v2-236b", "qwen2-72b"])
def test_launcher_serves_each_new_arch_on_the_cpu(name, capsys):
    prompt = 300 if name == "pixtral-12b" else 40
    toks = serve.main(["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", str(prompt), "--gen", "3"])
    assert toks.shape == (2, 3) and toks.device.type == "cpu"
    assert f"[serve] {name}-smoke on cpu" in capsys.readouterr().out


def test_launcher_refuses_musicgen_with_the_reason():
    with pytest.raises(ValueError, match="decode step takes a frame"):
        serve.main(["--arch", "musicgen-medium", "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "2"])


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("name", ["musicgen-medium", "pixtral-12b"])
def test_make_batch_frontends(name):
    cfg = get_arch(name).reduced()
    shape = SHAPES["train_4k"]
    shape = dataclasses.replace(shape, global_batch=2, seq_len=300)
    a, b = pipeline.make_batch(cfg, shape, 3), pipeline.make_batch(cfg, shape, 3)
    c = pipeline.make_batch(cfg, shape, 4, embed_dtype=torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    emb = "frames" if name == "musicgen-medium" else "patches"
    assert a[emb].dtype == torch.bfloat16 and c[emb].dtype == torch.float32
    assert not torch.equal(a[emb].float(), c[emb])
    assert 0.08 < float(c[emb].std()) < 0.12
    if name == "musicgen-medium":
        assert set(a) == {"frames", "labels"}
        assert a["frames"].shape == (2, 300, cfg.d_model) and a["labels"].shape == (2, 300)
    else:
        assert set(a) == {"patches", "tokens", "labels"}
        assert a["patches"].shape == (2, pipeline.N_PATCHES, cfg.d_model)
        assert a["tokens"].shape == a["labels"].shape == (2, 300 - pipeline.N_PATCHES)
        assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["labels"].min()) >= 0 and int(a["labels"].max()) < cfg.vocab_size
    markov = pipeline.make_batch(cfg, shape, 3, mode="markov")
    assert all(torch.equal(a[k], markov[k]) for k in a)   # a frontend ignores the mode


@pytest.mark.parametrize("name", ["qwen3-14b", "musicgen-medium", "pixtral-12b"])
def test_input_specs_match_the_reference(name):
    cfg = get_arch(name)
    for key, shape in SHAPES.items():
        got = pipeline.input_specs(cfg, shape)
        want = jpipeline.input_specs(jget_arch(name), JSHAPES[key])
        assert set(got) == set(want), key
        for k, spec in got.items():
            assert tuple(spec.shape) == tuple(want[k].shape), (key, k)
            assert str(spec.dtype).split(".")[-1] == str(want[k].dtype), (key, k)
