"""Logical-axis sharding rules (`repro/dist/sharding.py`).

Every parameter declares logical axis names in its `models.spec.Spec`
(``embed``, ``mlp``, ``heads`` …).  ``LOGICAL_RULES`` maps them to mesh
axes; `pspec_for_spec` applies the map with the reference's fallback (a
dim that the mesh axis does not divide is replicated, and a mesh axis
appears at most once per leaf); `zero1_pspecs` adds the data-parallel
axes to the first still-replicated divisible dim of every leaf, the
ZeRO-1 sharding of the optimizer state.

A partition spec here is a tuple with one entry per dim: None, one mesh
axis name, or a tuple of several; it equals ``tuple(PartitionSpec(...))``
of the reference's (which writes a one-axis tuple as the name).  The
rules run on the reference's declared leaves (`models.spec.stacked_specs`:
a stack's leaves stacked on a leading ``layers`` axis, xLSTM's mLSTM
leaves on two), so that a pspec tree mirrors the reference's parameter
tree and may put the data axis on a stacked axis; `dist/zero1.py` reads
that as a rank owning whole layers.  Only the mesh's axis names and
sizes are read (`launch.mesh.mesh_shape`); `named` turns pspecs into
`DTensor` placements for a `DeviceMesh`.

The port's own model-axis layout (`tp_layouts`, one `LeafLayout` per
parameter of a rank's shard) is read from `params_pspecs`, with one
departure: the port cuts only whole heads.  An attention module whose
head counts the model axis does not divide (its query heads, and for
GQA its KV heads) is held whole on every rank and computed there with
no collective, where GSPMD may cut its (heads·head_dim)-wide dims mid
head (Qwen3-14B's 40 query heads at M = 16: 2.5 a shard).  Every other
leaf is cut where its pspec puts the model axis: whole rows or columns
(an MLP's hidden units, whole experts, rows of the vocabulary, the
untied table's embedding columns).  `shard_leaf` takes a rank's slice.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import MODEL_AXIS, mesh_shape
from repro_torch.models.spec import Spec, Stack, iter_specs, stacked_specs

# logical axis → mesh axis (None: always replicated).  Tensor parallelism
# ("model") shards the per-layer contraction-free dims; "embed" stays
# replicated so that the residual stream needs no gather inside a layer.
LOGICAL_RULES: Dict[str, Optional[str]] = {
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "vocab": "model",
    "embed": None,
    "layers": None,   # the stack's axis: never sharded by the rules
    "data": None,     # reserved for ZeRO-1 and the batch, applied apart
}

# Data-parallel axes, outer to inner; "pod" exists on multi-pod meshes only.
DP_AXES: Tuple[str, ...] = ("pod", "data")


def entry(axes: Tuple[str, ...]):
    """One pspec entry for ``axes`` as PartitionSpec writes it: None for
    none, the name for one, the tuple for several."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def entry_axes(e) -> Tuple[str, ...]:
    """The mesh axes of one pspec entry."""
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def _axis_size(shape: Dict[str, int], name: str) -> int:
    return shape.get(name, 1) if name in shape else 0


def pspec_for_spec(spec: Spec, mesh, rules: Optional[Dict] = None) -> tuple:
    """The pspec of one parameter Spec on ``mesh``: a dim takes its logical
    rule's mesh axis iff the axis exists, has size > 1, divides the dim
    and no earlier dim of the leaf took it; else it is replicated."""
    rules = LOGICAL_RULES if rules is None else rules
    shape = mesh_shape(mesh)
    entries, used = [], set()
    for dim, logical in zip(spec.shape, spec.axes):
        axis = rules.get(logical) if logical is not None else None
        size = _axis_size(shape, axis) if axis else 0
        if axis and axis not in used and size > 1 and dim % size == 0:
            entries.append(axis)
            used.add(axis)
        else:
            entries.append(None)
    return tuple(entries)


def map_specs(fn: Callable, tree):
    """``fn`` over every `Spec` leaf of a dict tree."""
    if isinstance(tree, Spec):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def params_pspecs(model, mesh) -> Any:
    """Pspecs (tensor parallelism only) mirroring the reference's
    parameter tree: the model's `stacked_specs`."""
    return map_specs(lambda s: pspec_for_spec(s, mesh), stacked_specs(model.specs()))


def dp_axes_for(dim: int, mesh) -> Tuple[str, ...]:
    """The largest suffix of the mesh's data-parallel axes (size > 1)
    whose product divides ``dim``."""
    shape = mesh_shape(mesh)
    dp = tuple(a for a in DP_AXES if _axis_size(shape, a) > 1)
    while dp and dim % math.prod(_axis_size(shape, a) for a in dp) != 0:
        dp = dp[1:]  # drop the outermost (pod) first
    return dp


def _with_zero1(spec: Spec, pspec: tuple, mesh) -> tuple:
    """The DP axes on the first replicated divisible dim (ZeRO-1)."""
    entries = list(pspec)
    for i, dim in enumerate(spec.shape):
        if entries[i] is not None:
            continue
        dp = dp_axes_for(dim, mesh)
        if dp:
            entries[i] = entry(dp)
            return tuple(entries)
    return pspec


def zero1_pspecs(model, mesh) -> Any:
    """ZeRO-1 pspecs: the tensor-parallel ones with the DP axes on each
    leaf's first free divisible dim, for the f32 masters' optimizer
    state.  Every mesh axis still appears at most once per leaf; a leaf
    with no divisible free dim keeps its tensor-parallel pspec."""
    return map_specs(lambda s: _with_zero1(s, pspec_for_spec(s, mesh), mesh),
                     stacked_specs(model.specs()))


def batch_pspecs(batch: Dict[str, Any], mesh) -> Dict[str, tuple]:
    """Each input's leading (batch) dim over the DP axes; one they do not
    divide is replicated.  Leaves are tensors or anything with a shape."""
    def one(x) -> tuple:
        shape = tuple(getattr(x, "shape", ()))
        if not shape:
            return ()
        return (entry(dp_axes_for(shape[0], mesh)), *([None] * (len(shape) - 1)))
    return {k: one(v) for k, v in batch.items()}


def cache_pspecs(cache: Any, mesh, model) -> Any:
    """Decode-cache pspecs: the model's per-family layout (batch over the
    DP axes, heads and channels over "model")."""
    return model.cache_pspecs(mesh, cache)


def map_pspecs(fn: Callable, tree):
    """``fn`` over every pspec (a plain tuple) of a tree of dicts, lists
    and NamedTuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_pspecs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_pspecs(fn, v) for v in tree))
    if isinstance(tree, list):
        return [map_pspecs(fn, v) for v in tree]
    return fn(tree)


def placements(mesh, pspec: tuple) -> tuple:
    """`DTensor` placements of one pspec: per mesh dim, `Shard(i)` for the
    tensor dim whose entry names it, else `Replicate()`."""
    out = []
    for axis in mesh_shape(mesh):
        dims = [i for i, e in enumerate(pspec) if axis in entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named(mesh, tree: Any) -> Any:
    """A pspec tree → a tree of `DTensor` placements on ``mesh``."""
    return map_pspecs(lambda p: placements(mesh, p), tree)


# ------------------------------------------------------ the model axis
class LeafLayout(NamedTuple):
    """How one parameter lies over the model axis: ``dim`` cut into
    ``parts`` equal slices, one per rank in rank order; ``dim`` None: the
    whole leaf on every rank."""
    dim: Optional[int] = None
    parts: int = 1


WHOLE = LeafLayout()


def attention_cut(cfg, size: int) -> bool:
    """Whether an attention module of ``cfg`` is cut over a model axis of
    ``size``: every rank takes whole query heads and, for GQA, whole KV
    heads (the same condition as `Model.cache_pspecs` puts on the KV
    cache's head dim)."""
    if size == 1:
        return False
    if cfg.attn_type == "mla":
        return cfg.n_heads % size == 0
    return cfg.n_heads % size == 0 and cfg.n_kv_heads % size == 0


def tp_layouts(model, mesh) -> Dict[str, LeafLayout]:
    """Each parameter of ``model`` (by its name, as `named_parameters`
    gives it) → its `LeafLayout` on ``mesh``'s model axis: the dim its
    reference leaf's pspec (`params_pspecs`) cuts over "model", less the
    leaf's stacked axes, but whole for an attention module whose heads
    the axis does not divide (`attention_cut`)."""
    size = mesh_shape(mesh).get(MODEL_AXIS, 1)
    pspecs = params_pspecs(model, mesh)
    cut_attn = attention_cut(model.cfg, size)
    out: Dict[str, LeafLayout] = {}
    for path, _ in iter_specs(model.specs()):
        key = [k for k in path if not isinstance(k, int)]
        pspec = pspecs
        for k in key:
            pspec = pspec[k]
        depth = len(path) - len(key)
        dims = [i - depth for i, e in enumerate(pspec) if MODEL_AXIS in entry_axes(e)]
        if not dims or ("attn" in key and not cut_attn):
            out[".".join(map(str, path))] = WHOLE
        else:
            out[".".join(map(str, path))] = LeafLayout(dims[0], size)
    return out


def shard_leaf(full, layout: LeafLayout, rank: int):
    """Rank ``rank``'s slice of ``full`` (a tensor or array) under
    ``layout``: a view, or ``full`` itself for a whole leaf."""
    if layout.dim is None:
        return full
    n = full.shape[layout.dim] // layout.parts
    index = [slice(None)] * len(full.shape)
    index[layout.dim] = slice(rank * n, (rank + 1) * n)
    return full[tuple(index)]


def shard_specs(specs, layouts: Dict[str, LeafLayout], prefix: Tuple = ()):
    """``specs`` with each leaf's shape cut as ``layouts`` says: the specs
    of one rank's shard (its init still draws by the whole leaf's)."""
    if isinstance(specs, Spec):
        lay = layouts.get(".".join(map(str, prefix)), WHOLE)
        if lay.dim is None:
            return specs
        shape = list(specs.shape)
        shape[lay.dim] //= lay.parts
        return replace(specs, shape=tuple(shape))
    if isinstance(specs, dict):
        return {k: shard_specs(v, layouts, prefix + (k,)) for k, v in specs.items()}
    return Stack([shard_specs(v, layouts, prefix + (i,)) for i, v in enumerate(specs)],
                 specs.layer, specs.axis)
