"""Admission slicing's protocol in the port vs the JAX package
(`tests/test_slicing.py` without its grouped-expert cases, a family the
port does not carry yet): `GemmDesc.slice`, `AttentionDesc.slice`,
`ScanDesc.slice`, `can_slice`, `slice_plan` with `SlicePlan`'s operand
split and merge, and `sliced_time`.

Plans (pieces, spans, kind, merge axis), eligibility and modeled times
must agree exactly.  Executed pieces go through the port's own
`execute_schedule` at one fixed tile, as the runtime would launch them:
their merge equals the unsliced run bitwise for row partitions (GEMM
rows, batch) on integer-valued float32 operands, where every sum is
exact whatever the order, and within the reference tests' 3e-4 for
attention's query-row pieces, which re-block the softmax.  The merged
results are also held within 3e-4 of the reference's Pallas bodies run
in interpret mode on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SLICE_OVERHEAD_S as JOVERHEAD
from repro.core import GemmRequest as JReq
from repro.core import slice_plan as jslice_plan
from repro.core import sliced_time as jsliced_time
from repro.core.op_desc import can_slice as jcan_slice
from repro.core.op_desc import op_from_key as jop_from_key
from repro.core.scheduler import GroupPlan as JGroupPlan
from repro.core.scheduler import Schedule as JSchedule
from repro.core.scheduler import execute_schedule as jexecute
from repro.kernels.gemm.ops import TileConfig as JTile
from repro_torch.core import (
    SLICE_OVERHEAD_S,
    AttentionDesc,
    GemmDesc,
    GroupPlan,
    ScanDesc,
    Schedule,
    bind_operands,
    compat_key,
    execute_schedule,
    family_of,
    slice_plan,
    sliced_time,
)
from repro_torch.core.op_desc import can_slice
from repro_torch.kernels.gemm import TileConfig
from tests.hypothesis_compat import given, settings, st

TILE = TileConfig(64, 128, 128)
# The reference's cases but for its grouped one: every family and axis,
# f32, odd sizes for the remainder-absorbing spans.
CASES = (
    GemmDesc(96, 64, 32, dtype="f32"),
    GemmDesc(7, 48, 16, ta=True, dtype="f32"),
    AttentionDesc(2, 4, 2, 64, 96, 32, causal=True, dtype="f32"),
    AttentionDesc(2, 4, 4, 32, 32, 16, causal=False, dtype="f32"),
    AttentionDesc(3, 2, 2, 1, 64, 32, causal=True, dtype="f32"),  # decode
    ScanDesc(4, 16, 2, 8, 8, "f32"),
)
PARTS = (1, 2, 3, 8, 1000)
# Descriptors of the traffic the runtime slices (a Qwen3-14B prompt
# layer's ops) beside the small cases, for the modeled times.
TIMED = CASES + (
    GemmDesc(4096, 5120, 5120), GemmDesc(4096, 17408, 5120),
    GemmDesc(4096, 5120, 17408), GemmDesc(1, 64, 64),
    AttentionDesc(1, 40, 8, 4096, 4096, 128), AttentionDesc(8, 40, 8, 1, 4096, 128),
    ScanDesc(4, 1024, 64, 64, 64), ScanDesc(1, 4096, 64, 64, 64),
)
TILES = (TileConfig(64, 128, 128), TileConfig(8, 256, 512),
         TileConfig(128, 512, 128, 4), TileConfig(32, 128, 128, 1, 3))


def _j(d):
    return jop_from_key(d.key())


def _plan(p):
    """A slice plan as plain data."""
    return ([d.key() for d in p.pieces], p.kind, tuple(p.spans), p.merge_axis,
            p.parts, p.parent.key())


def _shapes(d):
    fam = family_of(d)
    if fam == "gemm":
        return [(d.K, d.M) if d.ta else (d.M, d.K), (d.N, d.K) if d.tb else (d.K, d.N)]
    if fam == "flash_attention":
        return [(d.B, d.Hq, d.Sq, d.D), (d.B, d.Hkv, d.Skv, d.D),
                (d.B, d.Hkv, d.Skv, d.D)]
    return [(d.B, d.T, d.H, d.P), (d.B, d.T, d.H), (d.B, d.T, d.H, d.N),
            (d.B, d.T, d.H, d.N)]


def _operands(d, seed=0, integer=False):
    """Numpy inputs from a seed; ``integer``: small integers (for a scan,
    its decay ``da`` stays a float in (-0.5, 0])."""
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(_shapes(d)):
        if family_of(d) == "mamba_scan" and i == 1:
            out.append((rng.random(s) * -0.5).astype(np.float32))
        elif integer:
            out.append(rng.integers(-3, 4, size=s).astype(np.float32))
        else:
            out.append(rng.standard_normal(s).astype(np.float32))
    return out


def _run(descs, opss):
    """The port's `execute_schedule`, one mixed group at ``TILE``."""
    reqs = [bind_operands(d, tuple(ops)) for d, ops in zip(descs, opss)]
    sched = Schedule(groups=[GroupPlan(
        indices=list(range(len(reqs))), cd=len(reqs), tile=TILE, mode="mixed",
        modeled_time_s=0.0, tiles=[TILE] * len(reqs))])
    return execute_schedule(reqs, sched)


def _jrun(d, ops):
    """The reference's Pallas body in interpret mode, unsliced."""
    jd = _j(d)
    args = tuple(jnp.asarray(x) for x in ops)
    req = (JReq(desc=jd, a=args[0], b=args[1]) if family_of(d) == "gemm"
           else JReq(desc=jd, inputs=args))
    jt = JTile(TILE.bm, TILE.bn, TILE.bk)
    sched = JSchedule(groups=[JGroupPlan(indices=[0], cd=1, tile=jt, mode="mixed",
                                         modeled_time_s=0.0, tiles=[jt])])
    return np.asarray(jexecute([req], sched, interpret=True)[0])


# ------------------------------------------------------------------- plans
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("desc", CASES, ids=lambda d: d.key())
def test_slice_plan_matches_reference(desc, parts):
    assert _plan(slice_plan(desc, parts)) == _plan(jslice_plan(_j(desc), parts))
    assert [p.key() for p in desc.slice(parts)] == \
        [p.key() for p in _j(desc).slice(parts)]


@given(m=st.integers(1, 600), n=st.sampled_from([16, 48, 5120]),
       k=st.sampled_from([16, 17408]), ta=st.booleans(), batch=st.sampled_from([1, 3]),
       parts=st.integers(1, 12))
@settings(max_examples=40, deadline=None)
def test_gemm_slice_plans_match_reference_on_random_shapes(m, n, k, ta, batch, parts):
    d = GemmDesc(m, n, k, ta=ta, batch=batch)
    assert _plan(slice_plan(d, parts)) == _plan(jslice_plan(_j(d), parts))
    assert d.can_slice == _j(d).can_slice


@given(b=st.integers(1, 9), sq=st.integers(1, 4096), extra=st.integers(-64, 512),
       causal=st.booleans(), parts=st.integers(1, 12))
@settings(max_examples=40, deadline=None)
def test_attention_slice_plans_match_reference_on_random_shapes(b, sq, extra, causal,
                                                                parts):
    d = AttentionDesc(b, 8, 2, sq, max(1, sq + extra), 64, causal)
    assert _plan(slice_plan(d, parts)) == _plan(jslice_plan(_j(d), parts))
    assert (d.can_slice, d._slice_axis()) == (_j(d).can_slice, _j(d)._slice_axis())


@given(b=st.integers(1, 20), t=st.integers(1, 300), parts=st.integers(1, 12))
@settings(max_examples=30, deadline=None)
def test_scan_slice_plans_match_reference_on_random_shapes(b, t, parts):
    d = ScanDesc(b, t, 4, 16, 8)
    assert _plan(slice_plan(d, parts)) == _plan(jslice_plan(_j(d), parts))


@pytest.mark.parametrize("parts", [2, 3, 1000])
@pytest.mark.parametrize("desc", CASES, ids=lambda d: d.key())
def test_split_operands_match_reference(desc, parts):
    ops = _operands(desc)
    got = slice_plan(desc, parts).split_operands(tuple(torch.from_numpy(x) for x in ops))
    want = jslice_plan(_j(desc), parts).split_operands(tuple(jnp.asarray(x) for x in ops))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("desc", CASES, ids=lambda d: d.key())
def test_slice_one_is_identity(desc):
    assert desc.slice(1) == [desc]
    plan = slice_plan(desc, 1)
    assert plan.pieces == (desc,) and plan.parts == 1
    ops = tuple(torch.from_numpy(x) for x in _operands(desc))
    (piece_ops,) = plan.split_operands(ops)
    assert all(torch.equal(a, b) for a, b in zip(piece_ops, ops))


@pytest.mark.parametrize("desc", CASES, ids=lambda d: d.key())
def test_pieces_never_straddle_compat_classes(desc):
    for p in slice_plan(desc, 4).pieces:
        assert family_of(p) == family_of(desc)
        if family_of(desc) == "gemm":
            assert compat_key(p) == compat_key(desc) and p.batch == 1


ELIGIBILITY = (
    GemmDesc(1, 64, 64), GemmDesc(64, 64, 64, batch=4), GemmDesc(2, 64, 64),
    GemmDesc(64, 64, 64).with_batch(2), ScanDesc(1, 16, 2, 8, 8),
    ScanDesc(2, 16, 2, 8, 8), AttentionDesc(1, 2, 2, 1, 64, 32),
    AttentionDesc(2, 2, 2, 64, 32, 16, causal=True),
    AttentionDesc(2, 2, 2, 64, 32, 16, causal=False),
    AttentionDesc(1, 2, 2, 64, 32, 16, causal=True),
)


@pytest.mark.parametrize("desc", ELIGIBILITY, ids=lambda d: d.key())
def test_can_slice_eligibility_matches_reference(desc):
    assert (desc.can_slice, can_slice(desc)) == (_j(desc).can_slice,
                                                 jcan_slice(_j(desc)))
    assert _plan(slice_plan(desc, 8)) == _plan(jslice_plan(_j(desc), 8))
    if family_of(desc) == "flash_attention":
        assert desc._slice_axis() == _j(desc)._slice_axis()


# ------------------------------------------------------------ modeled time
def test_slice_overhead_is_the_reference_constant():
    assert SLICE_OVERHEAD_S == JOVERHEAD


@pytest.mark.parametrize("tile", TILES, ids=lambda t: t.key())
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("desc", TIMED, ids=lambda d: d.key())
def test_sliced_time_bitwise(desc, parts, tile):
    jt = JTile(tile.bm, tile.bn, tile.bk, tile.split_k, tile.stream_k)
    assert sliced_time(desc, tile, parts) == jsliced_time(_j(desc), jt, parts)


# --------------------------------------------------------------- execution
@pytest.mark.parametrize("parts", [2, 3, 1000])
@pytest.mark.parametrize("desc", CASES, ids=lambda d: d.key())
def test_sliced_execution_merges_to_the_unsliced_run(desc, parts):
    plan = slice_plan(desc, parts)
    integer = plan.kind != "sq"
    ops = tuple(torch.from_numpy(x) for x in _operands(desc, integer=integer))
    whole = _run([desc], [ops])[0]
    merged = plan.merge(_run(list(plan.pieces), plan.split_operands(ops)))
    assert merged.shape == whole.shape and merged.dtype == whole.dtype
    if integer:
        assert torch.equal(merged, whole), plan.kind
    else:
        np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=3e-4, atol=3e-4)


@given(m=st.integers(2, 40), n=st.sampled_from([16, 48]), k=st.sampled_from([16, 32]),
       parts=st.integers(2, 5), ta=st.booleans())
@settings(max_examples=8, deadline=None)
def test_gemm_slices_merge_bitwise_on_random_shapes(m, n, k, parts, ta):
    d = GemmDesc(m, n, k, ta=ta, dtype="f32")
    plan = slice_plan(d, parts)
    ops = tuple(torch.from_numpy(x) for x in _operands(d, seed=m, integer=True))
    whole = _run([d], [ops])[0]
    assert torch.equal(plan.merge(_run(list(plan.pieces), plan.split_operands(ops))),
                       whole)


@given(sq=st.integers(2, 48), extra=st.integers(0, 32), parts=st.integers(2, 4),
       causal=st.booleans())
@settings(max_examples=8, deadline=None)
def test_attention_sq_slices_merge_within_tolerance_on_random_shapes(sq, extra, parts,
                                                                     causal):
    d = AttentionDesc(2, 2, 2, sq, sq + extra, 16, causal=causal, dtype="f32")
    plan = slice_plan(d, parts)
    ops = tuple(torch.from_numpy(x) for x in _operands(d, seed=sq))
    whole = _run([d], [ops])[0]
    merged = plan.merge(_run(list(plan.pieces), plan.split_operands(ops)))
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("desc", CASES, ids=lambda d: d.key())
def test_merged_results_match_reference_interpret_run(desc):
    plan = slice_plan(desc, 3)
    ops = _operands(desc)
    merged = plan.merge(_run(list(plan.pieces),
                             plan.split_operands(tuple(torch.from_numpy(x) for x in ops))))
    np.testing.assert_allclose(merged.numpy(), _jrun(desc, ops), rtol=3e-4, atol=3e-4)
