"""Faults C1 and C2 of the port against the JAX package, and the grouped
and ragged launches' weights-by-pointer path, on the CPU.

- C1: a ``mixed`` group whose members carry no operands gives None for
  them in both packages, beside a real member's result.
- C2: ``out_dtype=float32`` on bf16 operands, for the single, split-K,
  Stream-K (planner geometry), grouped and ragged GEMMs.  The operands
  are small integers, exact in bf16, so every product and every f32 sum
  is exact whatever its order: the results are held bitwise, the
  reference tests' own tolerance for f32 output
  (`tests/test_kernel_stream_k.py:73-77`), and the sums exceed bf16's
  8-bit significand, so an output rounded to bf16 anywhere would fail.
- Pointers: `block_groups`, the port's one mirror of the ragged
  kernel's row-end lookup, equals the reference's block → group map,
  also within each chunk of at most `MAX_MEMBERS` members; the ragged
  launcher refuses member sizes that are not multiples of bm; the
  stacked and per-member weight forms give identical plain results; and
  `execute_schedule` hands `grouped_gemm` and `ragged_gemm` the
  requests' own weights, copied nowhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GemmDesc as JDesc
from repro.core import GemmRequest as JReq
from repro.core.scheduler import GroupPlan as JGroupPlan
from repro.core.scheduler import Schedule as JSchedule
from repro.core.scheduler import execute_schedule as jexecute
from repro.kernels.gemm import TileConfig as JTile
from repro.kernels.gemm import gemm as jgemm
from repro.kernels.grouped_gemm import grouped_gemm as jgrouped
from repro.kernels.grouped_gemm import ragged_gemm as jragged
from repro_torch.core import (
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    GroupPlan,
    Schedule,
    execute_schedule,
    requests_from_numpy,
)
from repro_torch.core import scheduler
from repro_torch.kernels.gemm import TileConfig, gemm
from repro_torch.kernels.grouped_gemm import (
    block_groups,
    grouped_gemm,
    ragged_gemm,
)
from repro_torch.kernels.grouped_gemm.kernel import (
    MAX_MEMBERS,
    ragged_chunks,
    ragged_matmul,
    row_ends,
)


def _ints(rng, shape):
    """Integer-valued operands in [-4, 4], exact in bf16."""
    return rng.integers(-4, 5, size=shape).astype(np.float32)


def _both(x):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


# ---------------------------------------------------------------------- C1
@pytest.mark.parametrize("live", [(), (1,), (0,)],
                         ids=["no-operands", "second-real", "first-real"])
def test_mixed_group_with_operand_free_members_matches_reference(live):
    """The reference returns None for an operand-free member of a mixed
    group (`repro/core/scheduler.py:519-550`); the port did device and
    buffer work for every member first and raised."""
    shapes = [(4, 32, 48), (8, 64, 48)]
    tiles = [TileConfig(8, 128, 128), TileConfig(8, 128, 128, split_k=2)]
    jtiles = [JTile(8, 128, 128), JTile(8, 128, 128, split_k=2)]
    psched = Schedule(groups=[GroupPlan(indices=[0, 1], cd=2, tile=tiles[0],
                                        mode="mixed", modeled_time_s=0.0,
                                        tiles=tiles)])
    jsched = JSchedule(groups=[JGroupPlan(indices=[0, 1], cd=2, tile=jtiles[0],
                                          mode="mixed", modeled_time_s=0.0,
                                          tiles=jtiles)])
    rng = np.random.default_rng(len(live))
    preqs, jreqs = [], []
    for j, (M, N, K) in enumerate(shapes):
        desc = GemmDesc(M, N, K, dtype="f32")
        jdesc = JDesc(M, N, K, dtype="f32")
        if j in live:
            a, b = _ints(rng, (M, K)), _ints(rng, (K, N))
            preqs += requests_from_numpy([GemmRequest(desc=desc)], [(a, b)],
                                         device="cpu")
            jreqs.append(JReq(desc=jdesc, a=jnp.asarray(a), b=jnp.asarray(b)))
        else:
            preqs.append(GemmRequest(desc=desc))
            jreqs.append(JReq(desc=jdesc))
    pout = execute_schedule(preqs, psched)
    jout = jexecute(jreqs, jsched, interpret=True)
    assert [o is None for o in pout] == [o is None for o in jout] == \
        [j not in live for j in range(len(shapes))]
    for p, j in zip(pout, jout):
        if p is not None:
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))


# ---------------------------------------------------------------------- C2
def _gemm_case(tile_kw, ta, tb, M=9, N=70, K=600):
    rng = np.random.default_rng([M, N, K, int(ta), int(tb), *tile_kw.values()])
    a = _ints(rng, (K, M) if ta else (M, K))
    b = _ints(rng, (N, K) if tb else (K, N))
    (ja, pa), (jb, pb) = _both(a), _both(b)
    ref = jgemm(ja, jb, ta=ta, tb=tb, tile=JTile(8, 128, 128, **tile_kw),
                out_dtype=jnp.float32, interpret=True)
    out = gemm(pa, pb, ta=ta, tb=tb, tile=TileConfig(8, 128, 128, **tile_kw),
               out_dtype=torch.float32)
    return out, ref


def _grouped_case(_, ta, tb):
    rng = np.random.default_rng([3, int(ta), int(tb)])
    a, b = _ints(rng, (3, 9, 300)), _ints(rng, (3, 300, 70))
    (ja, pa), (jb, pb) = _both(a), _both(b)
    ref = jgrouped(ja, jb, tile=JTile(8, 128, 128), out_dtype=jnp.float32,
                   interpret=True)
    ws = [pb[g].T.contiguous().T for g in range(3)] if tb else pb
    return grouped_gemm(pa, ws, tile=TileConfig(8, 128, 128),
                        out_dtype=torch.float32), ref


def _ragged_case(_, ta, tb):
    rng = np.random.default_rng([4, int(ta), int(tb)])
    sizes = [16, 8, 0, 24]
    a, b = _ints(rng, (sum(sizes), 300)), _ints(rng, (len(sizes), 300, 70))
    (ja, pa), (jb, pb) = _both(a), _both(b)
    ref = jragged(ja, jb, jnp.asarray(sizes, jnp.int32), tile=JTile(8, 128, 128),
                  out_dtype=jnp.float32, interpret=True)
    ws = [pb[g].T.contiguous().T for g in range(len(sizes))] if tb else pb
    return ragged_gemm(pa, ws, sizes, tile=TileConfig(8, 128, 128),
                       out_dtype=torch.float32), ref


C2_CASES = {
    "single": lambda ta, tb: _gemm_case({}, ta, tb),
    "split-K": lambda ta, tb: _gemm_case({"split_k": 4}, ta, tb),
    "Stream-K": lambda ta, tb: _gemm_case({"stream_k": 3}, ta, tb),
    "grouped": lambda ta, tb: _grouped_case(None, ta, tb),
    "ragged": lambda ta, tb: _ragged_case(None, ta, tb),
}


@pytest.mark.parametrize("ta,tb", [(False, False), (True, True)],
                         ids=["nn", "tt"])
@pytest.mark.parametrize("kind", list(C2_CASES))
def test_f32_output_of_bf16_operands_matches_reference_bitwise(kind, ta, tb):
    out, ref = C2_CASES[kind](ta, tb)
    assert out.dtype == torch.float32
    want = np.asarray(ref)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(out.numpy(), want)
    # the f32 sums carry more than bf16's 8 significant bits
    assert not torch.equal(out, out.to(torch.bfloat16).float())


def test_out_dtype_defaults_to_the_operands_dtype():
    rng = np.random.default_rng(7)
    _, pa = _both(_ints(rng, (4, 64)))
    _, pb = _both(_ints(rng, (64, 16)))
    assert gemm(pa, pb).dtype == torch.bfloat16
    assert grouped_gemm(pa[None], pb[None]).dtype == torch.bfloat16
    assert ragged_gemm(pa, pb[None], [4]).dtype == torch.bfloat16


# ----------------------------------------------------------------- pointers
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("bm", [1, 8, 16, 64, 128])
def test_row_end_lookup_equals_block_groups(seed, bm):
    """Random sizes with zero-size members and rows past the last end:
    `block_groups` over all row ends gives every bm block the member of
    the reference's map (`repro/kernels/grouped_gemm/ops.py:73-78`), and
    so does the lookup within each chunk of at most `MAX_MEMBERS`
    members (the chunk's own row ends, as the kernel is given them:
    its first member's end, then its sizes); the chunks cover every
    block once."""
    rng = np.random.default_rng([seed, bm])
    G = int(rng.integers(1, 3 * MAX_MEMBERS))
    sizes = [int(s) * bm if rng.random() > 0.3 else 0
             for s in rng.integers(0, 4, size=G)]
    Mtotal = sum(sizes) + int(rng.integers(0, 3)) * bm + int(rng.integers(0, bm))
    if Mtotal == 0:
        Mtotal = bm
    n_blocks = -(-Mtotal // bm)
    want = jnp.minimum(
        jnp.searchsorted(jnp.cumsum(jnp.asarray(sizes, jnp.int32)),
                         jnp.arange(n_blocks, dtype=jnp.int32) * bm,
                         side="right").astype(jnp.int32), G - 1).tolist()
    assert block_groups(torch.tensor(sizes, dtype=torch.int32), n_blocks, bm,
                        G).tolist() == want
    ends = row_ends(sizes)
    got = []
    for ch in ragged_chunks(ends, Mtotal, bm):
        assert ch.g1 - ch.g0 <= MAX_MEMBERS and ch.row_lo % bm == 0
        own = torch.tensor([ends[ch.g0]] + sizes[ch.g0 + 1:ch.g1], dtype=torch.int32)
        lookup = block_groups(own, n_blocks, bm, ch.g1 - ch.g0).tolist()
        got += [ch.g0 + lookup[r // bm] for r in range(ch.row_lo, ch.row_hi, bm)]
    assert got == want


@pytest.mark.parametrize("sizes,bm", [([4, 8], 8), ([16, 12, 16], 16),
                                      ([0, 64, 32, 128], 64)])
def test_ragged_launcher_refuses_sizes_off_the_block(sizes, bm):
    """A member's size (but the last's) that is not a multiple of bm would
    put rows of two members in one kernel block, a function other than
    the plain version's: the launcher raises before it looks at the
    tensors (here on the CPU, where it would otherwise refuse them for
    not being CUDA tensors) and launches nothing."""
    a = torch.ones((sum(sizes), 8), dtype=torch.bfloat16)
    b = torch.ones((len(sizes), 8, 8), dtype=torch.bfloat16)
    before = ragged_matmul.launches
    with pytest.raises(ValueError, match=f"not multiples of bm={bm}"):
        ragged_matmul(a, b, sizes, bm=bm)
    assert ragged_matmul.launches == before
    with pytest.raises(ValueError, match="CUDA"):   # the last size is free
        ragged_matmul(a, b, [bm] * (len(sizes) - 1) + [3], bm=bm)


def _weights(rng, G, K, N, tb):
    """A stacked (G, K, N) bf16 tensor, or, when ``tb``, the transposed
    view of one stored (G, N, K)."""
    x = torch.from_numpy(rng.standard_normal((G, N, K) if tb else (G, K, N))
                         .astype(np.float32)).to(torch.bfloat16)
    return x.transpose(1, 2) if tb else x


@pytest.mark.parametrize("tb", [False, True], ids=["kn", "nk"])
@pytest.mark.parametrize("op", ["grouped", "ragged"])
def test_stacked_and_per_member_weights_give_identical_results(op, tb):
    rng = np.random.default_rng([int(tb), len(op)])
    G, K, N = 4, 96, 40
    b = _weights(rng, G, K, N, tb)
    members = list(b.unbind(0))
    members[3] = members[1]          # two members sharing one weight
    stacked = torch.stack(members)   # the same weights, one (G, K, N) tensor
    if op == "grouped":
        a = torch.from_numpy(rng.standard_normal((G, 5, K)).astype(np.float32))
        a = a.to(torch.bfloat16)
        outs = [grouped_gemm(a, w, out_dtype=dt) for w in (stacked, members)
                for dt in (None, torch.float32)]
    else:
        sizes = [8, 0, 16, 8]
        a = torch.from_numpy(rng.standard_normal((sum(sizes) + 3, K))
                             .astype(np.float32)).to(torch.bfloat16)
        outs = [ragged_gemm(a, w, sizes, out_dtype=dt) for w in (stacked, members)
                for dt in (None, torch.float32)]
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert outs[0].dtype == torch.bfloat16 and outs[1].dtype == torch.float32


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False),
                                   (True, True)])
@pytest.mark.parametrize("ms", [[8, 8, 8, 8], [8, 8, 8, 16, 4, 16]],
                         ids=["grouped", "ragged"])
def test_execute_schedule_hands_the_ops_the_requests_own_weights(
        monkeypatch, ms, ta, tb):
    """A spy on the scheduler's `grouped_gemm` / `ragged_gemm`: each
    member's weight is the request's own tensor (same storage and data
    pointer; transposed members as a view), and the results still match
    the plain GEMM bitwise."""
    seen = []

    def spy(op):
        def call(a, b, *args, **kw):
            seen.append(list(b))
            return op(a, b, *args, **kw)
        return call

    monkeypatch.setattr(scheduler, "grouped_gemm", spy(grouped_gemm))
    monkeypatch.setattr(scheduler, "ragged_gemm", spy(ragged_gemm))
    descs = [GemmDesc(m, 96, 80, ta, tb, "f32") for m in ms]
    sched = ConcurrencyController(GOLibrary()).plan(descs)
    mode = "ragged" if len(set(ms)) > 1 else "grouped"
    assert {g.mode for g in sched.groups} == {mode}
    rng = np.random.default_rng([len(ms), int(ta), int(tb)])
    ops = [(_ints(rng, (80, m) if ta else (m, 80)),
            _ints(rng, (96, 80) if tb else (80, 96))) for m in ms]
    reqs = requests_from_numpy([GemmRequest(desc=d) for d in descs], ops,
                               device="cpu")
    outs = execute_schedule(reqs, sched)
    assert sum(len(ws) for ws in seen) == len(reqs)
    handed = [w for ws in seen for w in ws]
    order = [i for g in sched.groups for i in g.indices]
    for i, w in zip(order, handed):
        r = reqs[i]
        assert w.data_ptr() == r.b.data_ptr()
        assert w.untyped_storage().data_ptr() == r.b.untyped_storage().data_ptr()
        assert tuple(w.shape) == (80, 96) and (w is r.b) == (not tb)
    for r, out in zip(reqs, outs):
        want = (r.a.T if ta else r.a) @ (r.b.T if tb else r.b)
        np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_ragged_sizes_as_a_list_or_a_tensor_agree():
    rng = np.random.default_rng(11)
    a = torch.from_numpy(_ints(rng, (40, 32)))
    b = torch.from_numpy(_ints(rng, (3, 32, 24)))
    sizes = [16, 8, 8]
    assert torch.equal(ragged_gemm(a, b, sizes),
                       ragged_gemm(a, b, torch.tensor(sizes, dtype=torch.int32)))
