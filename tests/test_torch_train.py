"""The port's training path (`repro_torch.optim`, `repro_torch.train.
train_loop`, `Model.loss`, the markov data and the loader) on the CPU
against the JAX package, on the same weights, state and inputs.

- C12: the port draws every normal leaf at the reference's σ =
  scale/√max(shape[0] of the leaf as the reference declares it, 1),
  exactly, for the three ported configs at full size and reduced; a
  drawn leaf's sample std lies within 3% of the reference's.
- `cross_entropy`, `Model.loss` and its gradients for reduced Qwen3-14B,
  DeepSeek-V2-Lite (the reference's own init tree, carried across) and
  Zamba2-1.2B (that tree rescaled, `fan_in_rescaled`), f32, against
  ``jax.value_and_grad(model.loss)``.  Tolerance: max |Δ| ≤
  tol·max(1, max |reference|) per tensor, tol = 1e-4 (the models'
  tests') but for the MoE model's gradients, 1e-3: its router's
  renormalised top-k weights make the reduced DeepSeek's f32 gradients
  ill-conditioned — the reference's own f32 gradient of the token table
  lies 2.7e-4·max from its float64 gradient (the same tree in float64,
  ``jax_enable_x64``) at this shape, batch and seed, and the port's
  2.3e-4.
- AdamW (`cosine_schedule`, `AdamW.update`) on the same gradients and
  state: the reference's update op for op, within 1e-6·max(1, |ref|).
- `make_train_step` at 1 and 2 microbatches against the reference's;
  the reference's `test_grad_accumulation_matches_single_batch`, ported;
  a reference `TrainState` after 2 steps carried across
  (`train_state_from_reference`), then 2 more steps in each package.
  Masters after a step: each element's move within STEP_TOL·lr of the
  reference's where the reference's last gradient is above twice its
  tolerance (there AdamW's step is set by the gradient; measured 3.6e-4
  of lr at most, and a missing decay term moves a unit norm scale by
  0.1·lr), and every element within 2.1·lr, the bound the reference's
  own test takes (a first step moves a parameter by ≈ lr·sign(g), so an
  infinitesimal gradient whose sign differs moves it by up to 2·lr).
- The cast and the decay follow the dims the reference declares, its
  stacked layer axis included: a stacked layer's vector is cast to bf16
  and decayed.  A step on zero gradients moves each master by its decay
  term alone, as the reference's within one f32 rounding.  A bf16 step against the
  reference's bf16 step: each gradient's dtype equal, the loss within
  2⁻⁸·max(1, |ref|) (one bf16 rounding), each leaf's gradient within
  twice the reference's own bf16 rounding of it (‖Δ‖ against the
  reference's bf16 and f32 gradients; the port lies at most 1.54× that
  far at this seed, DeepSeek's reduced MoE 58% from its own f32 there).
- The markov stream (every label one of its token's 4 successors), the
  input specs against the reference's, the loader's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.shapes import InputShape as JInputShape
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models.spec import Spec as JSpec
from repro.optim import adamw as jadamw
from repro.train import train_loop as jtrain
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.data import DataLoader, input_specs, make_batch
from repro_torch.data.pipeline import successor_table
from repro_torch.models import Model, build_model
from repro_torch.models.common import cross_entropy
from repro_torch.models.convert import unstacked
from repro_torch.models.spec import iter_specs
from repro_torch.optim import AdamW, AdamWConfig, AdamWState, cosine_schedule
from repro_torch.train.train_loop import (TrainState, make_train_step, train_init,
                                          train_state_from_reference)
from tests.test_torch_models import assert_close, pair, to_np, tokens

MODELS = ("qwen3-14b", "zamba2-1.2b", "deepseek-v2-lite-16b")
GRAD_TOL = {"qwen3-14b": 1e-4, "zamba2-1.2b": 1e-4, "deepseek-v2-lite-16b": 1e-3}
OPT_TOL = 1e-6
STEP_TOL = 1e-2
LR = 1e-3


def _batch(pr, seed: int, B: int = 2, T: int = 40) -> dict:
    toks = tokens(seed, (B, T + 1), pr.cfg.vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _by_name(pr, tree) -> dict:
    """A reference tree (params, grads or moments) by the port's names."""
    return unstacked(pr.model, to_np(tree))


# ------------------------------------------------------------------- C12
def _ref_sigma(spec: JSpec) -> float:
    fan = spec.shape[0] if len(spec.shape) > 1 else int(np.prod(spec.shape))
    return spec.scale / np.sqrt(max(fan, 1))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", MODELS)
def test_init_sigma_is_the_references_rule(name, reduced):
    """Every leaf's init kind, and every normal leaf's σ, as the
    reference's `init_params` computes them from its (stacked) specs."""
    jcfg = jget_arch(name).reduced() if reduced else jget_arch(name)
    cfg = get_arch(name).reduced() if reduced else get_arch(name)
    model = Model(cfg, device="meta")
    jspecs = jbuild_model(jcfg).specs()
    normal = 0
    for path, spec in iter_specs(model.specs()):
        ref = jspecs
        for k in path:
            if not isinstance(k, int):
                ref = ref[k]
        stacked = len(ref.shape) - len(spec.shape)
        assert ref.shape[stacked:] == spec.shape, path
        assert ref.init == spec.init, path
        if spec.init == "normal":
            normal += 1
            assert spec.scale / np.sqrt(max(spec.fan_in, 1)) == _ref_sigma(ref), path
    assert normal > 0


@pytest.mark.parametrize("name", MODELS)
def test_drawn_std_matches_the_reference(name):
    """Large leaves of the port's init (a generator from a seed) against
    the reference's own init at the same reduced config: sample std
    within 3%."""
    cfg = get_arch(name).reduced()
    jm = jbuild_model(jget_arch(name).reduced())
    ours = build_model(cfg, device="cpu", seed=3)
    ref = _by_name(pair(name), jax.jit(jm.init)(jax.random.PRNGKey(3)))
    specs = {".".join(map(str, p)): s for p, s in iter_specs(ours.specs())}
    big = 0
    for n, p in ours.named_parameters():
        if specs[n].init != "normal" or p.numel() < 8192:
            continue
        big += 1
        got, want = float(p.std()), float(np.std(ref[n]))
        assert abs(got / want - 1) < 0.03, (n, got, want)
    assert big >= 2


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("ignored", [0, 7])
def test_cross_entropy_against_the_reference(ignored):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 9, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    labels.reshape(-1)[rng.permutation(27)[:ignored]] = -1
    mask = rng.random((3, 9)) < 0.7
    for m in (None, mask):
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        assert_close(got, want, "cross_entropy")
    all_ignored = cross_entropy(torch.zeros(2, 3, 5), -torch.ones(2, 3, dtype=torch.int32))
    assert float(all_ignored) == 0.0


@pytest.mark.parametrize("name", MODELS)
def test_model_loss_and_gradients_against_the_reference(name):
    """`Model.loss` (ce + 1e-3·aux, metrics ce and aux) and its gradients
    with respect to every parameter, f32, against the reference's
    ``jax.value_and_grad(model.loss)`` on the same tree and batch."""
    pr = pair(name)
    batch = _batch(pr, 30)
    (jl, jm), jg = jax.jit(jax.value_and_grad(pr.jmodel.loss, has_aux=True))(
        pr.params, _j(batch))
    params = [p for _, p in pr.model.named_parameters()]
    for p in params:
        p.requires_grad_(True)
    loss, metrics = pr.model.loss(_t(batch))
    grads = torch.autograd.grad(loss, params)
    for p in params:
        p.requires_grad_(False)
    assert_close(loss, jl, "loss")
    assert_close(metrics["ce"], jm["ce"], "ce")
    assert_close(metrics["aux"], jm["aux"], "aux")
    want = _by_name(pr, jg)
    for (n, _), g in zip(pr.model.named_parameters(), grads):
        assert_close(g, want[n], f"grad {n}", GRAD_TOL[name])


# ------------------------------------------------------------------- AdamW
def _opt_cfg(**kw):
    kw = dict(dict(lr=LR, total_steps=20, warmup_steps=3), **kw)
    return AdamWConfig(**kw), jadamw.AdamWConfig(**kw)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7, 19, 20, 25])
def test_cosine_schedule_against_the_reference(step):
    cfg, jcfg = _opt_cfg()
    assert_close(cosine_schedule(cfg, step), jadamw.cosine_schedule(jcfg, step),
                 "lr", OPT_TOL)


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_against_the_reference(clip):
    """Three updates of a matrix and a vector on the same gradients and
    state: parameters, moments, step, gnorm and lr as the reference's."""
    cfg, jcfg = _opt_cfg(clip_norm=clip)
    rng = np.random.default_rng(5)
    p0 = {"w": rng.standard_normal((6, 5)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    opt, jopt = AdamW(cfg), jadamw.AdamW(jcfg)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, jstate = opt.init(params), jopt.init(jparams)
    for _ in range(3):
        g = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32) for k, v in p0.items()}
        params, state, m = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                      state, params)
        jparams, jstate, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                          jstate, jparams)
        for k in p0:
            assert_close(params[k], jparams[k], f"param {k}", OPT_TOL)
            assert_close(state.mu[k], jstate.mu[k], f"mu {k}", OPT_TOL)
            assert_close(state.nu[k], jstate.nu[k], f"nu {k}", OPT_TOL)
        assert int(state.step) == int(jstate.step)
        assert_close(m["gnorm"], jm["gnorm"], "gnorm", OPT_TOL)
        assert_close(m["lr"], jm["lr"], "lr", OPT_TOL)
    assert state.mu["w"].dtype == state.nu["b"].dtype == torch.float32


# -------------------------------------------------------------- train step
def _ref_state(pr, jopt):
    return jtrain.TrainState(pr.params, jopt.init(pr.params), jnp.zeros((), jnp.int32))


def _assert_state(state: TrainState, jstate, pr, what: str, tol: float) -> None:
    for field, got, want in (("params", state.params, jstate.params),
                             ("mu", state.opt.mu, jstate.opt.mu),
                             ("nu", state.opt.nu, jstate.opt.nu)):
        want = _by_name(pr, want)
        for n, t in got.items():
            assert_close(t, want[n], f"{what} {field} {n}", tol)
    assert int(state.step) == int(jstate.step)
    assert int(state.opt.step) == int(jstate.opt.step)


def _keep(store: dict):
    """A gradient transform that keeps the gradients it is handed."""
    def tf(g):
        store["g"] = g
        return g
    return tf


def _assert_moves(old: dict, new: dict, ref_old: dict, ref_new: dict, ref_grads: dict,
                  lr: float, name: str) -> None:
    """Each master's move (new − old) within STEP_TOL·lr of the reference's
    (ref_new − ref_old) where the reference's gradient is above twice its
    tolerance, and within 2.1·lr everywhere (module docstring)."""
    held = 0
    for n, p in new.items():
        g = ref_grads[n]
        sure = np.abs(g) > 2 * GRAD_TOL[name] * max(1.0, float(np.abs(g).max()))
        err = np.abs((p.numpy() - old[n]) - (ref_new[n] - ref_old[n]))
        assert err.max() <= 2.1 * lr, n
        if sure.any():
            assert err[sure].max() <= STEP_TOL * lr, (n, float(err[sure].max()) / lr)
            held += int(sure.sum())
    assert held > 0


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("name", ["qwen3-14b", "zamba2-1.2b"])
def test_train_step_against_the_reference(name, micro):
    """One f32 `make_train_step` step from the same state and batch in both
    packages: metrics (loss, ce, aux, gnorm, lr), the gradients the step
    hands its transform, and the new masters (`_assert_moves`)."""
    pr = pair(name)
    cfg, jcfg = _opt_cfg()
    opt, jopt = AdamW(cfg), jadamw.AdamW(jcfg)
    jstate = _ref_state(pr, jopt)
    state = train_state_from_reference(pr.model, to_np(jstate))
    old = {k: v.clone() for k, v in state.params.items()}
    batch = _batch(pr, 31, B=4)
    got_g, want_g = {}, {}
    new, m = make_train_step(pr.model, opt, compute_dtype=torch.float32,
                             n_microbatches=micro, grad_transform=_keep(got_g))(state, _t(batch))

    def jstep(st, b):
        new, metrics = jtrain.make_train_step(pr.jmodel, jopt, compute_dtype=jnp.float32,
                                              n_microbatches=micro,
                                              grad_transform=_keep(want_g))(st, b)
        return new, metrics, want_g["g"]

    jnew, jm, jg = jax.jit(jstep)(jstate, _j(batch))
    for k in ("loss", "ce", "aux", "gnorm", "lr"):
        assert_close(m[k], jm[k], k)
    want = _by_name(pr, jg)
    for n, g in got_g["g"].items():
        assert_close(g, want[n], f"grad {n}", GRAD_TOL[name])
    old = {k: v.numpy() for k, v in old.items()}
    _assert_moves(old, new.params, old, _by_name(pr, jnew.params), want, float(jm["lr"]),
                  name)
    assert int(new.step) == 1


def test_grad_accumulation_matches_single_batch():
    """The reference's test of the same name, on the port: 4 microbatches
    give the full batch's loss and gradients (up to the reduction order)
    and parameters within the first step's 2·lr sign bound."""
    cfg = get_arch("qwen3-14b").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    opt = AdamW(AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1))
    state = train_init(model, opt)
    batch = make_batch(cfg, InputShape("t", 32, 8, "train"), 0)
    g1, g4 = {}, {}

    def fresh():
        return TrainState({k: v.clone() for k, v in state.params.items()},
                          AdamWState(state.opt.step, *({k: v.clone() for k, v in d.items()}
                                                        for d in (state.opt.mu, state.opt.nu))),
                          state.step)

    s1 = make_train_step(model, opt, compute_dtype=torch.float32, grad_transform=_keep(g1))
    s4 = make_train_step(model, opt, compute_dtype=torch.float32, n_microbatches=4,
                         grad_transform=_keep(g4))
    st1, m1 = s1(fresh(), batch)
    st4, m4 = s4(fresh(), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    for k in g1["g"]:
        np.testing.assert_allclose(g1["g"][k].numpy(), g4["g"][k].numpy(),
                                   rtol=1e-4, atol=1e-4)
    for k in st1.params:
        np.testing.assert_allclose(st1.params[k].numpy(), st4.params[k].numpy(),
                                   rtol=1e-3, atol=2.1e-3)


def test_microbatches_must_divide_the_batch():
    """A batch the microbatch count does not divide raises, as the
    reference's reshape does, instead of leaving rows out."""
    cfg = get_arch("qwen3-14b").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    opt = AdamW(AdamWConfig())
    step = make_train_step(model, opt, compute_dtype=torch.float32, n_microbatches=2)
    batch = make_batch(cfg, InputShape("t", 8, 3, "train"), 0)
    with pytest.raises(ValueError, match="3 rows"):
        step(train_init(model, opt), batch)


def _ref_step(pr, jopt, dtype, transform):
    """The reference's step at ``dtype`` with ``transform``, jitted,
    returning (state, metrics, the gradients the transform was handed)."""
    seen = {}

    def tf(g):
        g = transform(g)
        seen["g"] = g
        return g

    def step(st, b):
        new, metrics = jtrain.make_train_step(pr.jmodel, jopt, compute_dtype=dtype,
                                              grad_transform=tf)(st, b)
        return new, metrics, seen["g"]
    return jax.jit(step)


@pytest.mark.parametrize("name", MODELS)
def test_bf16_train_step_against_the_reference(name):
    """One bf16-compute step in both packages from the same f32 masters:
    every gradient in the dtype of the reference's (the cast follows the
    reference's declared dims, so a stacked layer's vector is bf16), the
    loss within one bf16 rounding, each leaf's gradient within twice the
    reference's own bf16 rounding of it (module docstring), and the
    masters f32."""
    pr = pair(name)
    cfg, jcfg = _opt_cfg()
    opt, jopt = AdamW(cfg), jadamw.AdamW(jcfg)
    batch = _batch(pr, 31)
    ref = {}
    for dt in (jnp.bfloat16, jnp.float32):
        ref[dt] = _ref_step(pr, jopt, dt, lambda g: g)(_ref_state(pr, jopt), _j(batch))
    _, jm, jg = ref[jnp.bfloat16]
    got = {}
    new, m = make_train_step(pr.model, opt, grad_transform=_keep(got))(
        train_state_from_reference(pr.model, to_np(_ref_state(pr, jopt))), _t(batch))
    bf16 = _by_name(pr, jax.tree.map(lambda g: np.full(g.shape, g.dtype == jnp.bfloat16), jg))
    want = _by_name(pr, jax.tree.map(lambda g: np.asarray(g.astype(jnp.float32)), jg))
    want32 = _by_name(pr, jax.tree.map(np.asarray, ref[jnp.float32][2]))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 2.0 ** -8 * max(1.0, abs(float(jm["loss"])))
    cast = 0
    for n, g in got["g"].items():
        assert g.dtype == (torch.bfloat16 if bf16[n].all() else torch.float32), n
        cast += g.dtype == torch.bfloat16 and new.params[n].dim() == 1
        assert new.params[n].dtype == torch.float32
        err = np.linalg.norm(g.float().numpy() - want[n])
        rounding = np.linalg.norm(want[n] - want32[n])
        assert err <= 2 * rounding, (n, err / max(rounding, 1e-30))
    assert cast > 0   # the stacked layers' vectors


@pytest.mark.parametrize("name", MODELS)
def test_weight_decay_follows_the_references_declared_dims(name):
    """A bf16 step on zero gradients: AdamW's moments stay zero, so each
    master moves by its decoupled decay term alone, −lr·wd·p on a leaf
    the reference declares with two or more dims (a stacked layer's
    vector too) and 0 elsewhere; the masters within one f32 rounding
    (2⁻²³ relative; XLA fuses the reference's update) of the reference's,
    where the decay term is lr·wd = 3.3e-5 of the master."""
    pr = pair(name)
    cfg, jcfg = _opt_cfg()
    opt, jopt = AdamW(cfg), jadamw.AdamW(jcfg)
    batch = _batch(pr, 32)
    jnew, _, _ = _ref_step(pr, jopt, jnp.bfloat16, lambda g: jax.tree.map(jnp.zeros_like, g))(
        _ref_state(pr, jopt), _j(batch))
    state = train_state_from_reference(pr.model, to_np(_ref_state(pr, jopt)))
    old = {k: v.clone() for k, v in state.params.items()}
    new, m = make_train_step(pr.model, opt, grad_transform=lambda g: {
        k: torch.zeros_like(v) for k, v in g.items()})(state, _t(batch))
    want = _by_name(pr, jnew.params)
    # each leaf's dims as the reference declares it, stacked axis included
    ndims = _by_name(pr, jax.tree.map(lambda x: np.full(x.shape, x.ndim), pr.params))
    decayed_vectors = 0
    for n, p in new.params.items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=2.0 ** -23, atol=0, err_msg=n)
        moved = not torch.equal(p, old[n])
        assert moved == (int(ndims[n].flat[0]) >= 2 and bool(old[n].any())), n
        decayed_vectors += moved and p.dim() == 1
    assert decayed_vectors > 0


@pytest.mark.parametrize("name", ["qwen3-14b", "zamba2-1.2b"])
def test_carried_train_state_steps_like_the_reference(name):
    """A reference `TrainState` after 2 steps, carried across, then 2 more
    steps in each package on the same batches: metrics per step, each
    step's moves of the masters (`_assert_moves`), and the state at the
    end (masters within 2.1·lr; moments, step)."""
    pr = pair(name)
    cfg, jcfg = _opt_cfg()
    opt, jopt = AdamW(cfg), jadamw.AdamW(jcfg)
    kept = {}

    def jstep_g(st, b):
        new, metrics = jtrain.make_train_step(pr.jmodel, jopt, compute_dtype=jnp.float32,
                                              grad_transform=_keep(kept))(st, b)
        return new, metrics, kept["g"]

    jstep = jax.jit(jstep_g)
    jstate = _ref_state(pr, jopt)
    batches = [_batch(pr, 40 + i) for i in range(4)]
    for b in batches[:2]:
        jstate, _, _ = jstep(jstate, _j(b))
    state = train_state_from_reference(pr.model, to_np(jstate))
    _assert_state(state, jstate, pr, "carried", 0.0)
    step = make_train_step(pr.model, opt, compute_dtype=torch.float32)
    for b in batches[2:]:
        old = {k: v.numpy().copy() for k, v in state.params.items()}
        ref_old = _by_name(pr, jstate.params)
        state, m = step(state, _t(b))
        jstate, jm, jg = jstep(jstate, _j(b))
        for k in ("loss", "gnorm", "lr"):
            assert_close(m[k], jm[k], k)
        _assert_moves(old, state.params, ref_old, _by_name(pr, jstate.params),
                      _by_name(pr, jg), float(jm["lr"]), name)
    assert int(state.step) == 4
    want = _by_name(pr, jstate.params)
    for n, p in state.params.items():
        assert np.abs(p.numpy() - want[n]).max() <= 2.1 * LR, n
    for field, got, ref in (("mu", state.opt.mu, jstate.opt.mu),
                            ("nu", state.opt.nu, jstate.opt.nu)):
        ref = _by_name(pr, ref)
        for n, t in got.items():
            assert_close(t, ref[n], f"{field} {n}", 1e-3)


# -------------------------------------------------------------------- data
def test_markov_labels_are_successors_of_their_tokens():
    cfg = get_arch("qwen3-14b").reduced()
    shape = InputShape("t", 64, 4, "train")
    b = make_batch(cfg, shape, 0, mode="markov")
    b2 = make_batch(cfg, shape, 1, mode="markov")
    assert b["tokens"].shape == b["labels"].shape == (4, 64)
    assert not torch.equal(b["tokens"], b2["tokens"])
    assert torch.equal(b["tokens"], make_batch(cfg, shape, 0, mode="markov")["tokens"])
    succ = successor_table(cfg.vocab_size)
    toks, labels = b["tokens"].numpy(), b["labels"].numpy()
    assert (succ[toks] == labels[..., None]).any(-1).all()
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError, match="mode"):
        make_batch(cfg, shape, 0, mode="zipf")


@pytest.mark.parametrize("shape", [("t", 32, 4, "train"), ("p", 32, 4, "prefill"),
                                   ("d", 32, 4, "decode")], ids=lambda s: s[3])
def test_input_specs_against_the_reference(shape):
    for name in MODELS:
        specs = input_specs(get_arch(name), InputShape(*shape))
        want = jpipeline.input_specs(jget_arch(name), JInputShape(*shape))
        assert set(specs) == set(want)
        for k, s in specs.items():
            assert s.shape == want[k].shape
            assert str(s.dtype).split(".")[-1] == str(want[k].dtype)
        if shape[3] == "train":
            b = make_batch(get_arch(name), InputShape(*shape), 0)
            assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == \
                {k: (s.shape, s.dtype) for k, s in specs.items()}


def test_loader_prefetches_in_order():
    cfg = get_arch("qwen3-14b").reduced()
    loader = DataLoader(cfg, InputShape("t", 16, 2, "train"), start_step=3, mode="markov")
    got = [next(loader) for _ in range(5)]
    loader.close()
    assert [s for s, _ in got] == [3, 4, 5, 6, 7]
    for s, b in got:
        want = make_batch(cfg, InputShape("t", 16, 2, "train"), s, mode="markov")
        assert torch.equal(b["tokens"], want["tokens"])
        assert b["tokens"].device.type == "cpu"
    assert not loader._thread.is_alive()


def test_parameters_require_grad_only_when_asked():
    """Serving's parameters are frozen; ``requires_grad=True`` makes every
    parameter a leaf that `Model.loss(...).backward()` fills, equal to the
    gradients `make_train_step` takes of the same masters in f32."""
    cfg = get_arch("zamba2-1.2b").reduced()
    assert not any(p.requires_grad for p in build_model(cfg, device="cpu").parameters())
    model = build_model(cfg, device="cpu", seed=2, requires_grad=True)
    batch = make_batch(cfg, InputShape("t", 24, 2, "train"), 0, mode="markov")
    loss, _ = model.loss(batch)
    loss.backward()
    seen = {}

    def tf(g):
        seen.update(g)
        return g

    opt = AdamW(AdamWConfig())
    make_train_step(model, opt, compute_dtype=torch.float32, grad_transform=tf)(
        train_init(model, opt), batch)
    for n, p in model.named_parameters():
        assert p.requires_grad and p.grad is not None, n
        assert torch.allclose(p.grad, seen[n], rtol=1e-6, atol=1e-7), n
