"""The port's distribution logic (`repro_torch.dist`, `launch/mesh.py`,
`Runtime.set_mesh`) on the CPU against the JAX package.

- The sharding rules, bitwise: `params_pspecs`, `zero1_pspecs`,
  `batch_pspecs`, `cache_pspecs` and `Model.param_axes` of all ten
  configs at full size, on meshes (data, model) (1,1), (2,1), (1,4),
  (2,2), (4,2) and (pod, data, model) (2,2,2), every pspec equal to
  ``tuple(PartitionSpec)`` of the reference's.  Both packages get the
  same duck-typed meshes (axis names and a shape dict), as the
  reference's own tests pass them; the port's `MeshShape` is one.
- `mesh_resources`, `shard_fraction` and `TPUSpec.scaled` field for field;
  `compress_grads` over 5 steps with the error feedback carried, f32
  and bf16, bitwise.
- The reference's properties (`tests/test_dist_props.py`): each mesh axis
  at most once per leaf, ZeRO-1 shards strictly more than TP alone, the
  EF telescoping identity (deterministic and under hypothesis), one
  step's error within half a bucket.
- `named`'s DTensor placements; the mesh helpers on a one-rank gloo group.
- `set_mesh`: the reference's four `tests/test_dist_sched.py` tests, each
  run on both runtimes in shadow mode with the same descriptors, their
  launches and telemetry identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis_compat import given, settings, st  # skips if hypothesis missing
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_arch as jget_arch
from repro.core.cost_model import DEFAULT_SPEC as JSPEC
from repro.core.gemm_desc import GemmDesc as JDesc
from repro.core.scheduler import ConcurrencyController as JCtrl
from repro.dist import compress as jcompress
from repro.dist import resources as jresources
from repro.dist import sharding as jsharding
from repro.models import build_model as jbuild_model
from repro.runtime import Runtime as JRuntime
from repro_torch.configs import get_arch, list_archs
from repro_torch.core import ConcurrencyController, GemmDesc, GemmRequest
from repro_torch.core.cost_model import DEFAULT_SPEC
from repro_torch.core.scheduler import compat_key
from repro_torch.dist import compress, resources, sharding
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import Model
from repro_torch.runtime import Runtime

MESHES = [dict(data=1, model=1), dict(data=2, model=1), dict(data=1, model=4),
          dict(data=2, model=2), dict(data=4, model=2), dict(pod=2, data=2, model=2)]
MESH_IDS = ["x".join(map(str, m.values())) for m in MESHES]
ARCHS = sorted(list_archs())


def _key(k):
    return getattr(k, "key", getattr(k, "name", k))


def _ref_flat(tree) -> dict:
    """path → tuple(PartitionSpec) of a reference pspec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_key(k) for k in path): tuple(p) for path, p in leaves}


def _flat(tree, path=()) -> dict:
    """path → pspec of one of the port's pspec trees."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _flat(t, path + (n,)).items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: v for n, t in zip(tree._fields, tree)
                for k, v in _flat(t, path + (n,)).items()}
    return {path: tree}


def _models(name):
    return Model(get_arch(name), device="meta"), jbuild_model(jget_arch(name))


# -------------------------------------------------------------- the rules
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_zero1_pspecs_equal_the_references(name, mesh):
    model, jm = _models(name)
    m = MeshShape(**mesh)
    for ours, ref in ((sharding.params_pspecs(model, m), jsharding.params_pspecs(jm, m)),
                      (sharding.zero1_pspecs(model, m), jsharding.zero1_pspecs(jm, m))):
        got, want = _flat(ours), _ref_flat(ref)
        assert got == want
        assert len(got) > 0


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ARCHS)
def test_cache_pspecs_equal_the_references(name, mesh):
    """On the caches both packages make at batches 12, 6 and 1 (the DP
    axes dividing the batch, part of them, none)."""
    model, jm = _models(name)
    m = MeshShape(**mesh)
    for batch in (12, 6, 1):
        cache = model.init_cache(batch, 16)
        jcache = jax.eval_shape(lambda: jm.init_cache(batch, 16, jnp.bfloat16))
        got = _flat(sharding.cache_pspecs(cache, m, model))
        want = _ref_flat(jsharding.cache_pspecs(jcache, m, jm))
        assert got == want
        assert len(got) > 0


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_batch_pspecs_equal_the_references(mesh):
    m = MeshShape(**mesh)
    for rows in (1, 2, 3, 4, 6, 8, 16):
        batch = {"tokens": np.zeros((rows, 7), np.int32), "labels": np.zeros((rows, 7)),
                 "frames": np.zeros((rows, 7, 5)), "scalar": np.zeros(())}
        want = {k: tuple(v) for k, v in jsharding.batch_pspecs(batch, m).items()}
        assert sharding.batch_pspecs(batch, m) == want


@pytest.mark.parametrize("name", ARCHS)
def test_param_axes_equal_the_references(name):
    model, jm = _models(name)
    leaves = jax.tree_util.tree_flatten_with_path(
        jm.param_axes(), is_leaf=lambda x: isinstance(x, tuple))[0]
    want = {tuple(_key(k) for k in path): axes for path, axes in leaves}
    assert _flat(model.param_axes()) == want


def test_rules_take_a_device_mesh_on_a_one_rank_group(tmp_path):
    """`make_debug_mesh` and `make_mesh_from_devices` on a one-rank gloo
    group: a `DeviceMesh` whose names and sizes the rules read as a
    `MeshShape`'s; a mesh that is not the group's size is refused."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        mesh = lmesh.make_debug_mesh(1, 1, device="cpu")
        assert lmesh.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert lmesh.mesh_shape(lmesh.make_mesh_from_devices("cpu")) == {"data": 1,
                                                                         "model": 1}
        model = Model(get_arch("qwen3-14b").reduced(), device="meta")
        assert sharding.zero1_pspecs(model, mesh) == sharding.zero1_pspecs(
            model, MeshShape(data=1, model=1))
        with pytest.raises(ValueError, match="needs 2 ranks"):
            lmesh.make_debug_mesh(2, 1, device="cpu")
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        lmesh.make_debug_mesh(1, 1, device="cpu")


def test_named_gives_dtensor_placements():
    m = MeshShape(pod=2, data=2, model=2)
    got = sharding.named(m, {"a": (("pod", "data"), None, "model"), "b": (None, None),
                             "c": None})
    assert got["a"] == (Shard(0), Shard(0), Shard(2))
    assert got["b"] == (Replicate(), Replicate(), Replicate())
    assert got["c"] is None


# ------------------------------------------------ resources, spec, compress
@pytest.mark.parametrize("mesh", MESHES + [dict(data=4), dict(pod=2, data=16, model=16)],
                         ids=MESH_IDS + ["4", "2x16x16"])
@pytest.mark.parametrize("max_cd", [16, 3])
def test_mesh_resources_equal_the_references(mesh, max_cd):
    m = MeshShape(**mesh)
    ours = resources.mesh_resources(m, max_cd=max_cd)
    ref = jresources.mesh_resources(m, max_cd=max_cd)
    assert ours.mesh_shape == ref.mesh_shape
    assert (ours.model_shards, ours.frac, ours.slot_budget) == (
        ref.model_shards, ref.frac, ref.slot_budget)
    assert dataclasses.asdict(ours.spec) == dataclasses.asdict(ref.spec)
    assert resources.shard_fraction(m) == jresources.shard_fraction(m)


@pytest.mark.parametrize("frac", [1.0, 0.5, 0.25, 1 / 16, 1 / 3])
def test_spec_scaled_equals_the_references(frac):
    assert dataclasses.asdict(DEFAULT_SPEC.scaled(frac)) == dataclasses.asdict(
        JSPEC.scaled(frac))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_over_five_steps_equals_the_references(dtype):
    """Five steps with the error feedback carried: the dequantized
    gradients and the buffers bitwise equal (both round half to even)."""
    rng = np.random.default_rng(11)
    shapes = {"w": (32, 16), "b": (16,), "tiny": (3, 5)}
    ef = compress.ef_init({k: torch.zeros(s) for k, s in shapes.items()})
    jef = jcompress.ef_init({k: jnp.zeros(s) for k, s in shapes.items()})
    for step in range(5):
        g = {k: (rng.normal(size=s) * 10.0 ** -(step + (k == "tiny") * 4)).astype(np.float32)
             for k, s in shapes.items()}
        q, ef = compress.compress_grads(
            {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in g.items()}, ef)
        jq, jef = jcompress.compress_grads(
            {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in g.items()}, jef)
        for k in shapes:
            assert str(q[k].dtype).endswith(dtype) and ef[k].dtype == torch.float32
            np.testing.assert_array_equal(q[k].float().numpy(),
                                          np.asarray(jq[k].astype(jnp.float32)))
            np.testing.assert_array_equal(ef[k].numpy(), np.asarray(jef[k]))
    assert compress.compressed_bytes(q) == jcompress.compressed_bytes(jq)
    with pytest.raises(ValueError):
        compress.compress_grads(q, {"w": ef["w"]})


# ------------------------------------------ the reference's properties
def _ef_roundtrip(gs):
    """(Σ q_t + ef_final, Σ g_t) for a gradient sequence."""
    ef = compress.ef_init({"w": gs[0]})
    qsum = torch.zeros_like(gs[0])
    for g in gs:
        gq, ef = compress.compress_grads({"w": g}, ef)
        qsum = qsum + gq["w"]
    return qsum + ef["w"], sum(gs)


def test_ef_telescoping_identity_deterministic():
    rng = np.random.default_rng(7)
    gs = [torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32)) for _ in range(12)]
    lhs, rhs = _ef_roundtrip(gs)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-4, rtol=1e-5)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.lists(st.floats(-10.0, 10.0, allow_nan=False, width=32),
                         min_size=8, max_size=8), min_size=1, max_size=10))
def test_ef_telescoping_identity_property(seq):
    gs = [torch.tensor(row, dtype=torch.float32) for row in seq]
    lhs, rhs = _ef_roundtrip(gs)
    scale = max(float(rhs.abs().max()), 1.0)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-4 * scale)


def test_ef_single_step_error_bounded_by_bucket():
    g = {"w": torch.from_numpy(np.random.default_rng(3).normal(size=(64,)).astype(np.float32))}
    _, ef = compress.compress_grads(g, compress.ef_init(g))
    bucket = float(g["w"].abs().max()) / 127.0
    assert float(ef["w"].abs().max()) <= bucket * 0.5 + 1e-7


def _leaf_axes(p: tuple) -> list:
    return [a for e in p for a in sharding.entry_axes(e)]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_zero1_each_mesh_axis_at_most_once(mesh):
    m = MeshShape(**mesh)
    z = _flat(sharding.zero1_pspecs(Model(get_arch("qwen3-14b").reduced(), device="meta"), m))
    for leaf in z.values():
        axes = _leaf_axes(leaf)
        assert len(axes) == len(set(axes)), leaf
        assert set(axes) <= set(m.axis_names), leaf


def test_zero1_shards_strictly_more_than_tp_only():
    model = Model(get_arch("qwen3-14b").reduced(), device="meta")
    m = MeshShape(data=2, model=2)
    base = _flat(sharding.params_pspecs(model, m)).values()
    z = _flat(sharding.zero1_pspecs(model, m)).values()
    assert sum(map(len, map(_leaf_axes, z))) > sum(map(len, map(_leaf_axes, base)))
    assert any("data" in _leaf_axes(p) for p in z)


@settings(max_examples=20, deadline=None)
@given(st.sampled_from([(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4)]))
def test_zero1_property_over_meshes(shape):
    model = Model(get_arch("stablelm-3b").reduced(), device="meta")
    for leaf in _flat(sharding.zero1_pspecs(model, MeshShape(data=shape[0],
                                                             model=shape[1]))).values():
        axes = _leaf_axes(leaf)
        assert len(axes) == len(set(axes))


# --------------------------------------------------------------- set_mesh
# Small-M GEMMs whose preferred CD saturates availability
# (`tests/test_dist_sched.py:WORKLOAD`).
WORKLOAD = [(64, 256, 256)] * 12


def _runtimes():
    return Runtime(device="cpu"), JRuntime()


def _launches(launches):
    return [(ln.class_key, ln.plan.mode, ln.plan.cd, ln.plan.tile.key(),
             [t.seq for t in ln.tickets], ln.plan.modeled_time_s, ln.start_t, ln.end_t)
            for ln in launches]


def _same_telemetry(rt, jrt):
    ps, js = rt.telemetry.summary(), jrt.telemetry.summary()
    ps.pop("class_ratios")
    js.pop("class_ratios")
    assert ps == js


def test_mesh_resources_arithmetic():
    for mr, spec in ((resources.mesh_resources, DEFAULT_SPEC),
                     (jresources.mesh_resources, JSPEC)):
        res = mr(MeshShape(data=2, model=4), max_cd=16)
        assert res.model_shards == 4 and res.slot_budget == 4
        assert res.frac == pytest.approx(0.25)
        assert res.spec.vmem_bytes == spec.vmem_bytes // 4
        assert res.spec.hbm_bw == pytest.approx(spec.hbm_bw / 4)
        res_dp = mr(MeshShape(data=4), max_cd=16)
        assert res_dp.slot_budget == 16 and res_dp.frac == 1.0
    assert resources.shard_fraction(MeshShape(pod=2, data=16, model=16)) == \
        pytest.approx(1 / 16)


def test_plan_never_exceeds_derated_budget():
    res = resources.mesh_resources(MeshShape(data=1, model=4), max_cd=16)
    jres = jresources.mesh_resources(MeshShape(data=1, model=4), max_cd=16)
    ctrl = ConcurrencyController()
    ctrl.spec = res.spec      # the port's controller takes its library's spec
    ours = ctrl.plan([GemmDesc(*d) for d in WORKLOAD], available=res.slot_budget)
    ref = JCtrl(spec=jres.spec).plan([JDesc(*d) for d in WORKLOAD],
                                     available=jres.slot_budget)
    assert ours.groups and all(g.cd <= res.slot_budget for g in ours.groups)
    assert [(g.cd, g.indices, g.mode) for g in ours.groups] == \
        [(g.cd, g.indices, g.mode) for g in ref.groups]
    single = ConcurrencyController().plan([GemmDesc(*d) for d in WORKLOAD], available=16)
    assert max(g.cd for g in single.groups) > res.slot_budget


def test_compat_grouping_unchanged_under_derating():
    """The compatibility-class partition is a property of the descriptors,
    not of the mesh: derating caps a group's size, never regroups."""
    shapes = ([(64, 256, 256), (32, 256, 256)] * 3 + [(64, 512, 128)] * 4)
    descs = [GemmDesc(*s) for s in shapes] + [GemmDesc(8, 256, 256, batch=4)] * 2
    assert len({compat_key(d) for d in descs}) == 3
    res = resources.mesh_resources(MeshShape(data=1, model=4), max_cd=16)
    single = ConcurrencyController().plan(descs, available=16)
    ctrl = ConcurrencyController()
    ctrl.spec = res.spec
    derated = ctrl.plan(descs, available=res.slot_budget)

    def classes(sched):
        out = {}
        for g in sched.groups:
            assert len({compat_key(descs[i]) for i in g.indices}) == 1
            out.setdefault(compat_key(descs[g.indices[0]]), []).extend(g.indices)
        return {k: sorted(v) for k, v in out.items()}
    assert classes(single) == classes(derated)
    # the same plans as the reference's, single-device and derated
    jdescs = [JDesc(*s) for s in shapes] + [JDesc(8, 256, 256, batch=4)] * 2
    jres = jresources.mesh_resources(MeshShape(data=1, model=4), max_cd=16)
    for ours, ref in ((single, JCtrl().plan(jdescs, available=16)),
                      (derated, JCtrl(spec=jres.spec).plan(jdescs,
                                                           available=jres.slot_budget))):
        assert [(g.cd, g.indices, g.mode) for g in ours.groups] == \
            [(g.cd, g.indices, g.mode) for g in ref.groups]


def test_runtime_set_mesh_caps_telemetry_cd():
    rt, jrt = _runtimes()
    res, jres = rt.set_mesh(MeshShape(data=1, model=4)), jrt.set_mesh(
        MeshShape(data=1, model=4))
    assert res.slot_budget == jres.slot_budget == rt.available == 4
    for d in WORKLOAD:
        rt.submit(GemmRequest(desc=GemmDesc(*d)), tenant="t0", now=0.0)
        jrt.submit(JDesc(*d), tenant="t0", now=0.0)
    assert _launches(rt.drain(now=0.0)) == _launches(jrt.drain(now=0.0))
    assert rt.telemetry.max_cd() <= res.slot_budget
    assert rt.telemetry.completed == len(WORKLOAD)
    _same_telemetry(rt, jrt)
    # the single-device runtime exceeds the derated budget on the same load
    rt1 = Runtime(device="cpu")
    for d in WORKLOAD:
        rt1.submit(GemmRequest(desc=GemmDesc(*d)), tenant="t0")
    rt1.drain(now=0.0)
    assert rt1.telemetry.max_cd() > res.slot_budget


def test_set_mesh_invalidates_plan_cache_and_rederates():
    rt, jrt = _runtimes()
    for d in WORKLOAD:
        rt.submit(GemmRequest(desc=GemmDesc(*d)), now=0.0)
        jrt.submit(JDesc(*d), now=0.0)
    assert _launches(rt.drain(now=0.0)) == _launches(jrt.drain(now=0.0))
    assert rt.plan_cache_size == jrt.plan_cache_size > 0
    chip_lib = rt.ctrl.lib
    rt._iso_cache["k"] = 1.0
    rt.set_mesh(MeshShape(data=1, model=4))
    jrt.set_mesh(MeshShape(data=1, model=4))
    assert rt.plan_cache_size == 0 and not rt._iso_cache
    # the GO library derates with the spec
    assert rt.ctrl.lib is not chip_lib
    assert rt.ctrl.lib.spec.vmem_bytes == rt.ctrl.spec.vmem_bytes
    assert dataclasses.asdict(rt.ctrl.spec) == dataclasses.asdict(jrt.ctrl.spec)
    # derated plans equal the reference's
    for d in WORKLOAD:
        rt.submit(GemmRequest(desc=GemmDesc(*d)), now=1.0)
        jrt.submit(JDesc(*d), now=1.0)
    assert _launches(rt.drain(now=1.0)) == _launches(jrt.drain(now=1.0))
    _same_telemetry(rt, jrt)
    # derived from the chip spec, never compounded
    first = rt.ctrl.spec.vmem_bytes
    rt.set_mesh(MeshShape(data=1, model=4))
    assert rt.ctrl.spec.vmem_bytes == first
    rt.set_mesh(MeshShape(data=4, model=1))
    assert rt.ctrl.spec.vmem_bytes == DEFAULT_SPEC.vmem_bytes
    assert rt.ctrl.lib is chip_lib
    assert rt.available == 16
