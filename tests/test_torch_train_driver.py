"""Checkpoints, the fault-tolerant driver and the training launcher of the
port (`repro_torch.dist`, `repro_torch.launch.train`) on the CPU.

The reference's `tests/test_dist_ft.py` (kill-and-resume bitwise, stop on
request, async checkpoints complete and ordered, rollback before the
first checkpoint) and `tests/test_launchers.py`'s two training tests
(end to end, and a run resumed from its checkpoints), ported; the
checkpoint layout and its atomic publication; the signal handlers put
back however a run ends; a launcher run resumed after a lost step
reproducing the uninterrupted run bit for bit; ``--mesh 1x2`` and
``2x2`` refused, naming ROADMAP A13c (training on the model axis; ``--mesh Dx1`` and
``--compress-grads`` run in `tests/test_torch_zero1.py`); ``--runtime``'s
slot budget equal to the reference runtime's on a 1×1 mesh; and the
launcher's refusal without CUDA.
"""
import json
import signal

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.runtime import Runtime as JRuntime
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.fault_tolerance import FaultTolerantDriver, FTConfig
from repro_torch.launch.train import main as train_main
from repro_torch.optim import AdamWState
from repro_torch.train.train_loop import TrainState


class Preempted(RuntimeError):
    pass


def _regression(tmp_path, **ft_kw):
    """Deterministic y = Wx regression; batches keyed by step id only."""

    def train_step(state, batch):
        w, aux = state
        x, y = batch
        w = w.detach().requires_grad_(True)
        loss = torch.mean((x @ w - y) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        return (w.detach() - 0.1 * g, aux), {"loss": loss.detach()}

    def batches():
        s = 0
        while True:
            x = torch.randn((8, 4), generator=torch.Generator().manual_seed(s))
            yield s, (x, x @ torch.ones((4, 2)))
            s += 1

    state = (torch.zeros((4, 2)), torch.zeros(()))
    return FaultTolerantDriver(train_step, state, FTConfig(ckpt_dir=str(tmp_path), **ft_kw)), batches


# -------------------------------------------------------------- the driver
def test_kill_and_resume_is_bitwise_identical(tmp_path):
    total, every, kill_at = 12, 4, 10
    ref_driver, ref_batches = _regression(tmp_path / "ref", ckpt_every=every)
    ref_driver.run(ref_batches(), total)

    def bomb(step, _state):
        if step == kill_at:
            raise Preempted(f"simulated preemption at {step}")

    d1, b1 = _regression(tmp_path / "ft", ckpt_every=every, step_hook=bomb)
    with pytest.raises(Preempted):
        d1.run(b1(), total)
    assert ckpt.latest_step(tmp_path / "ft") == 8

    d2, b2 = _regression(tmp_path / "ft", ckpt_every=every)
    start = d2.maybe_restore()
    assert start == 8
    out = d2.run(b2(), total, start_step=start)
    assert out["final_step"] == total
    assert torch.equal(ref_driver.state[0], d2.state[0])


def test_request_stop_checkpoints_current_step(tmp_path):
    driver, batches = _regression(tmp_path, ckpt_every=100)
    stop_at = 7

    def hook(step, _state):
        if step == stop_at:
            driver.request_stop()

    driver.cfg.step_hook = hook
    out = driver.run(batches(), 50)
    assert out["stopped"] is True
    assert out["final_step"] == stop_at
    assert ckpt.latest_step(tmp_path) == stop_at
    d2, _ = _regression(tmp_path, ckpt_every=100)
    assert d2.maybe_restore() == stop_at


def test_async_checkpoints_are_complete_and_ordered(tmp_path):
    driver, batches = _regression(tmp_path, ckpt_every=3, keep=2, async_ckpt=True)
    out = driver.run(batches(), 9)
    assert out["final_step"] == 9
    assert ckpt.all_steps(tmp_path) == [6, 9]
    assert not list(tmp_path.glob(".tmp-*"))
    restored, step = ckpt.restore(tmp_path, driver.state)
    assert step == 9
    assert torch.equal(driver.state[0], restored[0])


def test_rollback_uses_initial_snapshot_before_first_checkpoint(tmp_path):
    driver, batches0 = _regression(tmp_path, ckpt_every=50)

    def poisoned():
        for s, (x, y) in batches0():
            if s == 2:
                x = x * float("nan")
            yield s, (x, y)

    out = driver.run(poisoned(), 10)
    assert out["rollbacks"] == 1
    assert np.isfinite(out["losses"]).all()
    assert out["final_step"] == 10
    assert torch.isfinite(driver.state[0]).all()


def test_rollback_to_the_last_checkpoint_and_signals_put_back(tmp_path):
    """A NaN after a checkpoint rolls back to it; a SIGTERM mid-run stops
    the run with a checkpoint; after every run, however it ended, the
    previous handlers are back."""
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    driver, batches0 = _regression(tmp_path, ckpt_every=3)

    def poisoned():
        for s, (x, y) in batches0():
            yield s, ((x * float("nan")) if s == 5 else x, y)

    out = driver.run(poisoned(), 8)
    assert out["rollbacks"] == 1 and out["final_step"] == 8
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before

    def term(step, _state):
        if step == 10:
            signal.raise_signal(signal.SIGTERM)

    driver.cfg.step_hook = term
    out = driver.run(batches0(), 20, start_step=8)
    assert out["stopped"] and out["final_step"] == 10 and ckpt.latest_step(tmp_path) == 10
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before

    def bomb(step, _state):
        raise Preempted("mid-run")

    fresh, batches1 = _regression(tmp_path, ckpt_every=3, step_hook=bomb)
    with pytest.raises(Preempted):
        fresh.run(batches1(), 30, start_step=fresh.maybe_restore())
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before


# ------------------------------------------------------------- checkpoints
def _state():
    return TrainState({"w": torch.randn(3, 4), "b": torch.arange(4.0)},
                      AdamWState(torch.tensor(5, dtype=torch.int32),
                                 {"w": torch.ones(3, 4), "b": torch.zeros(4)},
                                 {"w": torch.full((3, 4), 2.0), "b": torch.ones(4)}),
                      torch.tensor(5, dtype=torch.int32))


def test_checkpoint_layout_and_round_trip(tmp_path):
    """``step_%08d/arrays.npz`` of the leaves in tree order and ``meta.json``;
    `restore` puts each leaf back in its place, dtype and device."""
    state = _state()
    final = ckpt.save(tmp_path, state, 42)
    assert final.name == "step_00000042"
    assert json.loads((final / "meta.json").read_text()) == {"step": 42, "n_leaves": 8}
    with np.load(final / "arrays.npz") as z:
        leaves = [z[f"leaf_{i}"] for i in range(8)]
    want = ckpt.tree_leaves(state)
    for a, t in zip(leaves, want):
        np.testing.assert_array_equal(a, t.numpy())
    like = ckpt.tree_map(torch.zeros_like, state)
    back, step = ckpt.restore(tmp_path, like)
    assert step == 42 and type(back) is TrainState and type(back.opt) is AdamWState
    for a, b in zip(ckpt.tree_leaves(back), want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="has 8 leaves, restore target has 2"):
        ckpt.restore(tmp_path, (torch.zeros(1), torch.zeros(1)))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", like)


def test_checkpoint_prunes_and_clears_stale_partials(tmp_path):
    """``keep`` newest steps survive; a partial write of a step left by a
    crash is removed by the next save of that step; stray names are not
    steps."""
    stale = tmp_path / ".tmp-step_00000003-1-2"
    stale.mkdir(parents=True)
    (stale / "arrays.npz").write_bytes(b"partial")
    (tmp_path / "step_notes").mkdir()
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, {"x": torch.full((2,), float(s))}, s, keep=2)
    assert ckpt.all_steps(tmp_path) == [3, 4]
    assert ckpt.latest_step(tmp_path) == 4
    assert not list(tmp_path.glob(".tmp-*"))
    got, _ = ckpt.restore(tmp_path, {"x": torch.zeros(2)}, step=3)
    assert torch.equal(got["x"], torch.full((2,), 3.0))


# ---------------------------------------------------------------- launcher
def _args(tmp_path, arch="qwen3-14b", **kw):
    opts = dict(batch=4, seq=32, steps=8, ckpt_every=4)
    opts.update(kw)
    out = ["--arch", arch, "--reduced", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    for k, v in opts.items():
        out += [f"--{k.replace('_', '-')}", str(v)]
    return out


@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-1.2b"])
def test_train_launcher_end_to_end(tmp_path, arch):
    result = train_main(_args(tmp_path, arch))
    assert len(result["losses"]) == 8
    assert np.isfinite(result["losses"]).all()
    assert result["final_step"] == 8 and result["rollbacks"] == 0
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())
    assert all(p.dtype == torch.float32 for p in result["state"].params.values())


def test_train_launcher_resumes(tmp_path):
    train_main(_args(tmp_path, steps=6, ckpt_every=3))
    out = train_main(_args(tmp_path, steps=10, ckpt_every=3))
    assert out["final_step"] == 10
    assert len(out["losses"]) == 4


def test_resumed_launcher_run_reproduces_the_uninterrupted_one(tmp_path):
    """8 steps with checkpoints at 4 and 8; step 8's checkpoint removed (a
    run lost after step 4); the same command resumes at step 4 and ends
    bitwise where the uninterrupted run ended."""
    args = _args(tmp_path, arch="zamba2-1.2b", steps=8, ckpt_every=4)
    first = train_main(args)
    assert ckpt.all_steps(tmp_path) == [4, 8]
    for p in (tmp_path / "step_00000008").iterdir():
        p.unlink()
    (tmp_path / "step_00000008").rmdir()
    second = train_main(args)
    assert second["losses"] == first["losses"][4:]
    for k, p in first["state"].params.items():
        assert torch.equal(p, second["state"].params[k]), k


@pytest.mark.parametrize("flag", [["--mesh", "1x2"], ["--mesh", "2x2"]])
def test_train_launcher_refuses_distribution(tmp_path, flag):
    """A model axis above 1 is training under tensor parallelism, ROADMAP
    A13c."""
    with pytest.raises(NotImplementedError, match="A13c"):
        train_main(_args(tmp_path) + flag)


def test_runtime_budget_equals_the_references_on_one_device(tmp_path):
    """The reference derates its runtime to a mesh's per-shard budget; on a
    1×1 mesh that is the whole chip (frac 1.0) and the controller's
    max_cd, which the port's runtime, on one device, has as made."""
    jrt = JRuntime()
    res = jrt.set_mesh(Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model")))
    assert res.frac == 1.0 and res.slot_budget == jrt.ctrl.max_cd == jrt.available
    out = train_main(_args(tmp_path, steps=2) + ["--runtime"])
    assert out["slot_budget"] == res.slot_budget
    tele = out["telemetry"]
    assert tele["submitted"] == tele["completed"] > 0
    assert tele["max_cd"] <= out["slot_budget"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_train_launcher_defaults_to_cuda_and_raises_without_it(tmp_path, no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--arch", "qwen3-14b", "--reduced", "--ckpt-dir", str(tmp_path)])
