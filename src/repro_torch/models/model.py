"""Models (`repro/models/model.py`): any ported architecture built from
its `ArchConfig`, as one `nn.Module`.

    specs() / param_count    — declarative specs (spec.py)
    forward(batch)           — full-sequence logits (+ MoE aux loss)
    loss(batch)              — training loss: cross-entropy + MoE aux
    init_cache / prefill / decode_step — serving with per-family caches

Every family of the reference: dense (Gemma3's local layers attend
through a sliding window), moe (capacity or expert-parallel path),
hybrid (zamba2), ssm (xLSTM groups), and audio and vlm, dense stacks
behind stub frontends (``frames`` replace the embedding; ``patches`` go
in front of the tokens).  A frontend's embeddings are cast to the model's dtype (the
reference's JAX promotes bf16 frames to f32 weights after the first
norm).  A layer stack is a `ModuleList` run in a Python loop (the
reference scans stacked weights).  Caches keep the reference's layout,
leading stack axes on each buffer (two for xLSTM's mLSTM layers), and
are written in place; ``cache_len`` is a host integer.  Training passes
no cache (`loss`); on the card the attention and scan kernels then run
through their autograd Functions.

``remat`` (`repro/models/model.py:178-186, 205, 220`) recomputes a
layer's activations in the backward instead of keeping them: "full"
checkpoints each layer's call (one xLSTM group, one Zamba2 layer with
its shared block) with `torch.utils.checkpoint`; "dots" does so for the
attention stacks keeping the 2-D matmul outputs (`aten.mm`,
`aten.addmm`: the dense GEMMs are `torch.matmul`), the analogue of
`dots_with_no_batch_dims_saveable`, and, as in the reference, remats
nothing in the hybrid and ssm families.  Under remat each layer's
attention and scan kernels launch twice a step: in the forward and in
its recompute.

The model axis (serving; the reference's GSPMD on a mesh with "model"
above 1): ``Model(cfg, mesh=...)`` builds this rank's shard of the
dense and MoE families, leaf by leaf (`dist.sharding.tp_layouts`), and
each module computes on its local shard with explicit collectives over
the mesh's model dim (`dist.tp`): attention on whole local heads and
the MLPs on their hidden units, each followed by one `all_reduce_sum`;
the vocabulary's table and head as `common.embed_apply` and
`lm_head_apply` say; the routed experts over `all_to_all` in a prefill
whose length the axis divides (``moe_mode="auto"``, as the reference's
`repro/models/blocks.py:85-97`; "ep" forces it) and otherwise on the
capacity path with the experts cut.  An attention module whose heads
the axis does not divide is whole on every rank, and so is its KV
cache (`Model.cache_pspecs`' rule).  Every rank ends a call with the
same residual stream and the same gathered logits.  The hybrid and ssm
families on a model axis above 1 raise (ROADMAP A13d), and so does a
sharded model that would train (A13c).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.dist import sharding as shd   # a module: it imports models.spec
from repro_torch.dist.tp import ModelAxis
from repro_torch.launch.mesh import MODEL_AXIS, mesh_shape
from repro_torch.models import blocks as B
from repro_torch.models.attention import init_kv_cache, init_mla_cache
from repro_torch.models.common import (
    cross_entropy,
    embed_apply,
    embed_specs,
    lm_head_apply,
    rms_norm,
    rms_norm_spec,
)
from repro_torch.models.spec import (
    ParamTree,
    build_params,
    init_params,
    init_tensor,
    param_axes,
    param_count,
    stack_specs,
    stacked_specs,
    tree_params,
)
from repro_torch.models.ssm import init_mamba_cache
from repro_torch.models.xlstm import init_mlstm_cache, init_slstm_cache

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
DENSE = ("dense", "audio", "vlm")      # one stack of dense attention blocks
MOE_AUX_COEF = 1e-3
REMAT = ("none", "full", "dots")
MOE_MODES = ("auto", "capacity", "ep")
# The matmuls whose outputs "dots" keeps: 2-D products, no batch dims.
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _check_ported(cfg: ArchConfig, moe_mode: str, remat: str, model_axis: int,
                  requires_grad: bool) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: one of {REMAT}")
    if moe_mode not in MOE_MODES:
        raise ValueError(f"moe_mode={moe_mode!r}: one of {MOE_MODES}")
    if model_axis > 1 and cfg.family not in ("moe", *DENSE):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on a model axis of {model_axis}: Mamba's in_proj "
            "and xLSTM's up-projection concatenate their streams in one cut dim; "
            "tensor parallelism of the hybrid and ssm families waits for ROADMAP A13d")
    if model_axis > 1 and requires_grad:
        raise NotImplementedError(
            f"training on a model axis of {model_axis} (autograd through the collectives, "
            "a vocab-parallel cross-entropy) waits for ROADMAP A13c")


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class _Layer(nn.Module):
    """``fn(*modules, *args)`` as a module call, so that a recompute can
    run it on the tensors its forward saw (`Model._remat`)."""

    def __init__(self, fn, *modules: nn.Module):
        super().__init__()
        self.fn = fn
        for i, m in enumerate(modules):
            self.add_module(str(i), m)

    def forward(self, *args):
        return self.fn(*self._modules.values(), *args)


class Model(nn.Module):
    """``cfg``'s model with empty parameters on ``device`` in ``dtype``
    (`build_model` initialises them).  ``moe_mode``: "auto" (expert
    parallelism in a prefill the model axis divides, else the capacity
    path), "capacity" or "ep".  ``requires_grad``: whether the
    parameters require grad (serving leaves them frozen; the training
    step differentiates with respect to its own cast of the masters).

    ``mesh`` (a `DeviceMesh` over the ranks, as `launch.mesh` makes it):
    this rank's shard of the model on the mesh's model axis (see the
    module's docstring); None, or a model axis of 1, is the whole model.
    ``rank`` with a mesh of shapes alone (`launch.mesh.MeshShape`) builds
    that rank's shard with no process group: its parameters, not its
    calls, which need the ranks' collectives."""

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32, moe_mode: str = "auto",
                 moe_capacity_factor: float = 1.25, remat: str = "none",
                 requires_grad: bool = False, mesh=None, rank: int | None = None):
        super().__init__()
        axis = 1 if mesh is None else mesh_shape(mesh).get(MODEL_AXIS, 1)
        _check_ported(cfg, moe_mode, remat, axis, requires_grad)
        self.cfg = cfg
        self.remat = remat
        self.moe_mode = moe_mode
        self.moe_capacity_factor = moe_capacity_factor
        self.tp = ModelAxis.of(mesh) if rank is None else ModelAxis.plan(mesh, rank)
        self.layouts = shd.tp_layouts(self, mesh) if axis > 1 else {}
        build_params(self, shd.shard_specs(self.specs(), self.layouts),
                     resolve_device(device), dtype, requires_grad)
        for name, module in self.named_modules() if self.layouts else ():
            if isinstance(module, ParamTree) and any(
                    self.layouts[f"{name}.{leaf}"].dim is not None
                    for leaf, _ in module.named_parameters(recurse=False)):
                module.tp = self.tp     # its own leaves are cut: it sums or gathers

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # ------------------------------------------------------------- specs
    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        s: Dict[str, Any] = {"embed": embed_specs(cfg.vocab_size, cfg.d_model,
                                                  cfg.tie_embeddings),
                             "final_norm": rms_norm_spec(cfg.d_model)}
        if cfg.family in DENSE:
            s["layers"] = stack_specs(
                B.attn_block_specs(cfg, cfg.d_ff, moe=False), cfg.n_layers)
        elif cfg.family == "moe":
            s["dense_layers"] = stack_specs(
                B.attn_block_specs(cfg, cfg.dense_d_ff or cfg.d_ff, moe=False),
                cfg.first_dense_layers)
            s["layers"] = stack_specs(B.attn_block_specs(cfg, cfg.d_ff, moe=True),
                                      cfg.n_layers - cfg.first_dense_layers)
        elif cfg.family == "hybrid":
            s["layers"] = stack_specs(B.zamba_layer_specs(cfg), cfg.n_layers)
            s["shared"] = B.zamba_shared_specs(cfg)
        else:  # ssm: xLSTM groups
            s["layers"] = stack_specs(B.xlstm_group_specs(cfg),
                                      cfg.n_layers // cfg.slstm_every)
        return s

    def param_count(self) -> int:
        return param_count(self.specs())

    def param_axes(self):
        """The logical axes of every leaf of the reference's parameter tree
        (its stacked declaration, `stacked_specs`)."""
        return param_axes(stacked_specs(self.specs()))

    def init(self, gen: torch.Generator) -> "Model":
        """Initialise every parameter from ``gen`` (on the model's device).
        A shard draws every leaf whole, in the one-rank order, and keeps
        its slice: its leaves are bitwise the one-rank model's slices."""
        if not self.layouts:
            init_params(self, self.specs(), gen)
            return self
        with torch.no_grad():
            for path, spec, p in tree_params(self, self.specs()):
                layout = self.layouts[".".join(map(str, path))]
                if layout.dim is None:
                    init_tensor(p, spec, gen)
                    continue
                full = torch.empty(spec.shape, dtype=torch.float32, device=p.device)
                init_tensor(full, spec, gen)
                p.copy_(shd.shard_leaf(full, layout, self.tp.rank))
        return self

    # ------------------------------------------------------- embeddings
    def _embed_inputs(self, batch):
        """The stack's input (`repro/models/model.py:86-93`): the audio
        stub's ``frames`` (B, T, D) in place of the embedding; the vision
        stub's ``patches`` (B, n, D) in front of the embedded tokens."""
        frontend, dt = self.cfg.frontend, self.embed.tok.dtype
        if frontend == "audio_frames":
            return batch["frames"].to(dt)
        x = embed_apply(self.embed, batch["tokens"])
        if frontend == "vision_patches":
            x = torch.cat([batch["patches"].to(dt), x], dim=1)
        return x

    # ------------------------------------------------------------ layers
    def _remat(self, fn, modules: tuple, *args, attention: bool = False):
        """``fn(*modules, *args)``, checkpointed when the model remats and
        grad is on (the serving path never is); "dots" applies to the
        ``attention`` stacks only.  The recompute runs on the tensors the
        forward saw: under the training step's `functional_call` those
        are its cast leaves, not the modules' own."""
        if (self.remat == "none" or not torch.is_grad_enabled()
                or (self.remat == "dots" and not attention)):
            return fn(*modules, *args)
        layer = _Layer(fn, *modules)
        tensors = dict(layer.named_parameters())

        def run(*a):
            return functional_call(layer, tensors, a)
        ctx = ({"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                _dots_policy)}
               if self.remat == "dots" else {})
        return checkpoint(run, *args, use_reentrant=False, **ctx)

    def _run_layers(self, x, positions, cache=None, cache_len: int = 0):
        cfg = self.cfg
        aux = torch.zeros((), device=x.device)
        if cfg.family in ("moe", *DENSE):
            if cfg.family == "moe" and cfg.first_dense_layers:
                x, _ = self._run_attn(self.dense_layers, x, positions, moe=False,
                                      cache=None if cache is None else cache["dense"],
                                      cache_len=cache_len, layer_offset=0)
            x, aux = self._run_attn(self.layers, x, positions,
                                    moe=cfg.family == "moe",
                                    cache=None if cache is None else cache["main"],
                                    cache_len=cache_len,
                                    layer_offset=cfg.first_dense_layers)
        elif cfg.family == "hybrid":
            for i, p in enumerate(self.layers):
                c = None if cache is None else {
                    "mamba": _layer(cache["mamba"], i), "kv": _layer(cache["kv"], i)}
                x, _ = self._remat(
                    functools.partial(B.zamba_layer_apply, cfg=cfg, positions=positions,
                                      layer_idx=i, cache=c, cache_len=cache_len),
                    (p, self.shared), x)
        else:  # ssm
            for g, p in enumerate(self.layers):
                c = None if cache is None else {
                    "mlstm": _layer(cache["mlstm"], g), "slstm": _layer(cache["slstm"], g)}
                x, _ = self._remat(functools.partial(B.xlstm_group_apply, cfg=cfg, cache=c),
                                   (p,), x)
        return rms_norm(self.final_norm, x, cfg.norm_eps), aux

    def window(self, i: int) -> int:
        """The attention window of layer ``i`` (counted over the whole
        model, `repro/models/model.py:136-171`): with a local/global ratio
        r, layer i is global (window 0) when i % (r + 1) == r and local
        (the sliding window) otherwise; without a ratio every layer takes
        the window (0 when the config has none)."""
        cfg = self.cfg
        r = cfg.local_global_ratio
        if cfg.sliding_window and r and i % (r + 1) == r:
            return 0
        return cfg.sliding_window

    def _run_attn(self, stack, x, positions, *, moe: bool, cache, cache_len: int,
                  layer_offset: int):
        aux = torch.zeros((), device=x.device)
        for i, p in enumerate(stack):
            block = functools.partial(
                B.attn_block_apply, cfg=self.cfg, positions=positions, moe=moe,
                window=self.window(layer_offset + i),
                cache=None if cache is None else _layer(cache, i),
                cache_len=cache_len, moe_capacity_factor=self.moe_capacity_factor,
                moe_mode=self.moe_mode, axis=self.tp)
            x, _, a = self._remat(block, (p,), x, attention=True)
            aux = aux + a
        return x, aux

    def _positions(self, x, start: int, T: int):
        return (torch.arange(start, start + T, device=x.device)[None]
                .expand(x.shape[0], T))

    # ----------------------------------------------------------- forward
    def forward(self, batch):
        """Full-sequence logits (B, T, V) and the MoE aux loss; ``batch``
        holds ``tokens``, or the frontend's ``frames`` or ``patches`` and
        ``tokens``."""
        x = self._embed_inputs(batch)
        x, aux = self._run_layers(x, self._positions(x, 0, x.shape[1]))
        return lm_head_apply(self.embed, x), aux

    def loss(self, batch):
        """The training loss (`repro/models/model.py:235-242`): mean token
        cross-entropy of ``batch["labels"]`` (labels < 0 ignored) plus
        `MOE_AUX_COEF` × the MoE load-balance loss; returns (loss,
        {"ce", "aux"}).  The vision stub's patches are unsupervised
        context: the labels align with the text tail."""
        logits, aux = self(batch)
        if self.cfg.frontend == "vision_patches":
            logits = logits[:, -batch["labels"].shape[1]:]
        ce = cross_entropy(logits, batch["labels"])
        return ce + MOE_AUX_COEF * aux, {"ce": ce, "aux": aux}

    def cache_pspecs(self, mesh, cache):
        """Pspecs of ``cache`` (an `init_cache` tree: tensors, or anything
        with a shape), the reference's layout
        (`repro/models/model.py:328-389`): batch over the data-parallel
        axes where they divide it (dropping the inner first), head and
        channel dims over "model" where it divides them."""
        entry = shd.entry
        shape = mesh_shape(mesh)
        dp_all = tuple(a for a in ("pod", "data") if a in shape)
        msize = shape.get("model", 1)

        def dp_for(b):
            dp = dp_all
            while dp and b % math.prod(shape[a] for a in dp) != 0:
                dp = dp[:-1]
            return entry(dp)

        def m_for(d):
            return "model" if (msize > 1 and d % msize == 0) else None

        def each(fn, tree):
            return None if tree is None else type(tree)(
                *(None if t is None else fn(t.shape) for t in tree))

        def kv_one(sh):   # k/v (L, B, S, H, hd); MLA ckv (L, B, S, r), krope
            if len(sh) == 5:
                return (None, dp_for(sh[1]), None, m_for(sh[3]), None)
            return (None, dp_for(sh[1]), None, None)

        def mamba_one(sh):
            if len(sh) == 5:   # state (L, B, H, N, P)
                return (None, dp_for(sh[1]), m_for(sh[2]), None, None)
            return (None, dp_for(sh[1]), None, m_for(sh[3]))   # conv

        def ml_one(sh):    # (G, k-1, B, ...)
            rest = [None] * (len(sh) - 3)
            if len(sh) >= 5:
                rest[0] = m_for(sh[3])
            return (None, None, dp_for(sh[2]), *rest)

        def sl_one(sh):    # (G, B, H, P)
            return (None, dp_for(sh[1]), m_for(sh[2]), None)

        fam = self.cfg.family
        if fam in DENSE:
            return {"dense": None, "main": each(kv_one, cache["main"])}
        if fam == "moe":
            return {"dense": each(kv_one, cache["dense"]), "main": each(kv_one, cache["main"])}
        if fam == "hybrid":
            return {"mamba": each(mamba_one, cache["mamba"]), "kv": each(kv_one, cache["kv"])}
        return {"mlstm": each(ml_one, cache["mlstm"]), "slstm": each(sl_one, cache["slstm"])}

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, s_max: int, dtype=torch.bfloat16) -> dict:
        """Zeroed caches, each buffer with a leading layer axis (xLSTM's
        mLSTM buffers two: group, layer of the group); the SSM and xLSTM
        states are float32 whatever ``dtype``."""
        cfg, dev = self.cfg, self.device
        if cfg.attn_type == "mla":
            kv = init_mla_cache       # the latents: whole on every rank
        else:                         # this rank's KV heads
            kv = functools.partial(init_kv_cache, heads=cfg.n_kv_heads // (
                self.tp.size if shd.attention_cut(cfg, self.tp.size) else 1))
        if cfg.family in DENSE:
            return {"dense": None,
                    "main": kv(cfg, batch, s_max, dtype, dev, cfg.n_layers)}
        if cfg.family == "ssm":
            groups = cfg.n_layers // cfg.slstm_every
            return {"mlstm": init_mlstm_cache(cfg, batch, dtype, dev,
                                              (groups, cfg.slstm_every - 1)),
                    "slstm": init_slstm_cache(cfg, batch, dtype, dev, (groups,))}
        if cfg.family == "moe":
            return {"dense": kv(cfg, batch, s_max, dtype, dev, cfg.first_dense_layers),
                    "main": kv(cfg, batch, s_max, dtype, dev,
                               cfg.n_layers - cfg.first_dense_layers)}
        return {"mamba": init_mamba_cache(cfg, batch, dtype, dev, cfg.n_layers),
                "kv": init_kv_cache(cfg, batch, s_max, dtype, dev, cfg.n_layers)}

    def prefill(self, batch, cache):
        """Feed a prompt (``batch`` as `forward` takes it); returns
        (last-position logits (B, 1, V), the cache written in place, its
        new length: the positions fed, patches included)."""
        x = self._embed_inputs(batch)
        T = x.shape[1]
        x, _ = self._run_layers(x, self._positions(x, 0, T), cache=cache,
                                cache_len=0)
        return lm_head_apply(self.embed, x[:, -1:]), cache, T

    def decode_step(self, tokens, cache, cache_len: int):
        """One position per sequence at ``cache_len``: tokens (B, 1), or
        for the audio stub frames (B, 1, D); returns (logits (B, 1, V),
        the cache, cache_len + 1)."""
        if self.cfg.frontend == "audio_frames":
            x = tokens.to(self.embed.tok.dtype)
        else:
            x = embed_apply(self.embed, tokens)
        x, _ = self._run_layers(x, self._positions(x, cache_len, 1),
                                cache=cache, cache_len=cache_len)
        return lm_head_apply(self.embed, x), cache, cache_len + 1


def _layer(stacked, i: int):
    """Layer ``i``'s views of a stacked cache (a NamedTuple of buffers)."""
    return type(stacked)(*(t[i] for t in stacked))


def build_model(cfg: ArchConfig, *, device="cuda", dtype: torch.dtype = torch.float32,
                seed: int | None = 0, **kw) -> Model:
    """``cfg``'s model on ``device`` (CUDA unless asked for the CPU; raises
    without it), its weights random from ``seed`` by a `torch.Generator`
    on that device, or left empty for `convert.from_reference` when
    ``seed`` is None.  With ``mesh=`` (and ``rank=``) it is this rank's
    shard (`Model`), drawn leaf by leaf: no rank holds the whole model."""
    model = Model(cfg, device=device, dtype=dtype, **kw)
    if seed is not None:
        model.init(torch.Generator(device=model.device).manual_seed(seed))
    return model
