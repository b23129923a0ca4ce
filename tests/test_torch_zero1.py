"""ZeRO-1 data parallelism (`repro_torch.dist.zero1`,
`make_train_step(zero1=...)`, the rank-aware fault-tolerant driver and
``launch.train --mesh Dx1``) on the CPU, over gloo.

- The plan alone (no group): every rank's slices of every parameter
  tile it exactly once across the DP ranks, as `zero1_pspecs` puts the
  data axis: whole layers where it lands on a stack's axis, equal row
  ranges of every layer's tensor elsewhere; each rank holds about
  1/data of the moments; `train_init` makes the moments of those slices.
- Multi-rank runs, each rank a spawned process, rendezvous through a
  file under the test's tmp_path, every collective with a 60 s timeout
  and every test's ranks joined within 120 s:
  - 3 f32-compute steps of reduced Qwen3-14B and Zamba2-1.2B on 2 ranks
    (and Qwen3 on 4) against one process on the full batch: losses,
    masters and the gathered moments within the tolerances below, each rank
    holding only its slice;
  - the launcher, ``--mesh 2x1 --compress-grads``: 4 steps with
    checkpoints at 2 and 4, step 4's removed, the same command resuming
    at 2: masters and error-feedback buffers bitwise the uninterrupted
    run's on both ranks;
  - the driver's ranks agreeing: a NaN on one rank's loss rolls every
    rank back, a stop asked on one rank stops every rank at one step.

The tolerances.  The ranks' mean gradient sums each rank's mean over
its half (or quarter) of the batch where one process sums the whole
batch: the same f32 terms in another order, δg ≈ 2⁻²⁴·Σ|terms| an
element.  Losses and moments carry that difference: DP_TOL = 1e-6 of
max(1, |reference|) (measured ≤ 1.6e-7 of a loss, ≤ 3e-7 of a moment).
An AdamW step moves a master by lr·g/(|g| + ε), which moves by lr·δg/ε
where |g| is near ε, up to 2·lr where a tiny gradient's sign flips:
masters within MASTER_TOL = 1e-2·lr, the bound `test_torch_train.py`
takes where the step is set by the gradient (measured ≤ 1.7e-3·lr at
these seeds and 3 steps).
"""
import math

import pytest
import torch

from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.zero1 import Zero1
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import Model, build_model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.train.train_loop import train_init
from torch_dist_workers import dp_steps, reduced, spawn

DP_TOL = 1e-6
LR = 1e-3   # torch_dist_workers.dp_setup's
MASTER_TOL = 1e-2 * LR


def _close(got: torch.Tensor, want: torch.Tensor, what: str, atol: float = 0.0) -> None:
    assert got.shape == want.shape, what
    err = float((got - want).abs().max()) if got.numel() else 0.0
    bound = atol or DP_TOL * max(1.0, float(want.abs().max()))
    assert err <= bound, f"{what}: |Δ| {err:.3g} > {bound:.3g}"


# ------------------------------------------------------------ the plan
# where the data axis lands: "layers" where data divides a stack's depth
# (Qwen3's reduced 2 layers, Zamba2's 4), "rows" of one dim elsewhere
@pytest.mark.parametrize("arch,data,kinds", [
    ("qwen3-14b", 2, {"layers", "rows"}), ("qwen3-14b", 4, {"rows"}),
    ("zamba2-1.2b", 2, {"layers", "rows"}), ("zamba2-1.2b", 4, {"layers", "rows"}),
    ("deepseek-v2-lite-16b", 2, {"rows"})])
def test_each_rank_holds_only_its_slice(arch, data, kinds):
    model = Model(reduced(arch), device="meta")
    mesh = MeshShape(data=data, model=1)
    plans = [Zero1(model, mesh, rank=r) for r in range(data)]
    seen = set()
    for name, p in model.named_parameters():
        cover = torch.zeros(p.shape, dtype=torch.int32)
        for z in plans:
            d, lo, hi = z.owned(name)
            cover.narrow(d, lo, hi - lo).add_(1)
        leaf, _ = plans[0]._leaf_of[name]
        if leaf.dim is None:
            assert bool((cover == data).all()), name      # replicated
            seen.add("replicated")
        else:
            assert bool((cover == 1).all()), name         # exactly one owner
            seen.add("layers" if leaf.dim < len(leaf.stack) else "rows")
    assert seen - {"replicated"} == kinds, seen
    opt = AdamW(AdamWConfig())
    total = 8 * sum(p.numel() for p in model.parameters())
    real = build_model(reduced(arch), device="cpu", seed=0)
    held = []
    for z in plans:
        st = train_init(real, opt, z)
        for k, m in st.opt.mu.items():
            assert m.shape == z.view(k, st.params[k]).shape, k
        held.append(sum(4 * t.numel() for t in (*st.opt.mu.values(), *st.opt.nu.values())))
    assert sum(held) >= total and max(held) <= 1.1 * total / data + 8 * 2 ** 12, \
        (held, total)


def test_model_axis_waits_for_a13b():
    with pytest.raises(NotImplementedError, match="A13b"):
        Zero1(Model(reduced("qwen3-14b"), device="meta"), MeshShape(data=1, model=2),
              rank=0)


# ---------------------------------------------------------- multi-rank
@pytest.mark.parametrize("arch,data", [("qwen3-14b", 2), ("zamba2-1.2b", 2),
                                       ("qwen3-14b", 4)])
def test_data_parallel_steps_match_one_process(tmp_path, arch, data):
    ranks = spawn(tmp_path, data, "dp_steps", arch=arch, data=data)
    one = dp_steps(arch, 1, zero1=False)
    for r, res in enumerate(ranks):
        for a, b in zip(res["losses"], one["losses"]):
            assert abs(a - b) <= DP_TOL * max(1.0, abs(b)), (r, res["losses"], one["losses"])
        assert res["losses"] == ranks[0]["losses"]
        for k, p in one["params"].items():
            _close(res["params"][k], p, f"rank {r} master {k}", MASTER_TOL)
            assert torch.equal(res["params"][k], ranks[0]["params"][k]), k
            _close(res["mu"][k], one["mu"][k], f"rank {r} mu {k}")
            _close(res["nu"][k], one["nu"][k], f"rank {r} nu {k}")
            d, lo, hi = res["owned"][k]
            want = list(p.shape)
            want[d] = hi - lo
            assert res["held"][k] == tuple(want), (r, k)
    total = sum(8 * p.numel() for p in one["params"].values())
    assert sum(res["held_bytes"] for res in ranks) < 1.2 * total
    assert max(res["held_bytes"] for res in ranks) < 1.2 * total / data


def _argv(ck, steps: int = 4) -> list:
    return ["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--steps", str(steps), "--ckpt-every", "2", "--log-every", "0",
            "--ckpt-dir", str(ck), "--mesh", "2x1", "--compress-grads"]


def test_launcher_on_two_ranks_resumes_bit_for_bit(tmp_path):
    ck = tmp_path / "ck"
    first = spawn(tmp_path, 2, "launcher", argv=_argv(ck))
    assert ckpt.all_steps(ck) == [2, 4]
    for r in first:
        assert r["ranks"] == 2 and r["final_step"] == 4 and len(r["losses"]) == 4
        assert r["losses"] == first[0]["losses"]
        assert all(math.isfinite(x) for x in r["losses"])
        assert r["opt_bytes"] < 0.6 * r["opt_bytes_total"]
    for p in (ck / "step_00000004").iterdir():
        p.unlink()
    (ck / "step_00000004").rmdir()
    (tmp_path / "again").mkdir()
    second = spawn(tmp_path / "again", 2, "launcher", argv=_argv(ck))
    for a, b in zip(first, second):
        assert b["losses"] == a["losses"][2:] and b["step"] == 4
        for k, p in a["params"].items():
            assert torch.equal(b["params"][k], p), k
            assert torch.equal(b["ef"][k], a["ef"][k]), k


def test_ranks_roll_back_and_stop_alike(tmp_path):
    res = spawn(tmp_path, 2, "ft_agree", ckpt_dir=str(tmp_path / "ck"), poison_step=3,
                stop_step=4)
    assert res[0] == res[1]
    assert res[0]["rollbacks"] == 1 and res[0]["stopped"] and res[0]["final_step"] == 4
    assert len(res[0]["losses"]) == 4
    assert ckpt.all_steps(tmp_path / "ck")[-1] == 4
