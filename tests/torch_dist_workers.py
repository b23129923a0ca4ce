"""Rank processes for the port's multi-rank CPU tests
(`tests/test_torch_zero1.py`): gloo over a file rendezvous, a short
collective timeout, each rank's result saved beside the rendezvous file.
Imports no JAX: every rank starts from a fresh interpreter (spawn)."""
from __future__ import annotations

import math
import multiprocessing
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.data.pipeline import make_batch
from repro_torch.dist.fault_tolerance import FaultTolerantDriver, FTConfig
from repro_torch.dist.zero1 import Zero1
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.train.train_loop import make_train_step, train_init

JOIN_S = 120          # each test's own limit on its ranks
COLLECTIVE_S = 60     # a hung collective fails instead of stalling


def spawn(tmp_path: Path, world: int, fn: str, **kw) -> list:
    """Run ``fn(**kw)`` on ``world`` gloo ranks; returns each rank's result.
    Fails if a rank fails or does not finish within JOIN_S."""
    ctx = multiprocessing.get_context("spawn")
    rdv, out = tmp_path / f"rdv-{fn}", tmp_path / f"out-{fn}"
    procs = [ctx.Process(target=_rank, args=(r, world, str(rdv), fn, kw, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} of {fn} still running after {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{fn}: exit codes {codes}"
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]


def _rank(rank: int, world: int, rdv: str, fn: str, kw: dict, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=COLLECTIVE_S))
    try:
        torch.save(globals()[fn](**kw), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def reduced(arch: str):
    return get_arch(arch).reduced()


def dp_setup(arch: str, data: int, zero1: bool = True, steps: int = 3):
    """The reduced model, its f32-compute step (data parallel on a
    ``data`` x 1 mesh with ``zero1``) and its initial state."""
    cfg = reduced(arch)
    model = build_model(cfg, device="cpu", seed=0)
    z = Zero1(model, make_debug_mesh(data, 1, device="cpu")) if zero1 else None
    opt = AdamW(AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=1))
    state = train_init(model, opt, z)
    step = make_train_step(model, opt, compute_dtype=torch.float32, zero1=z)
    return cfg, z, state, step


def batch_of(cfg, i: int, rows: int = 8, seq: int = 16) -> dict:
    return make_batch(cfg, InputShape("t", seq, rows, "train"), i)


def dp_steps(arch: str, data: int, steps: int = 3, zero1: bool = True) -> dict:
    """``steps`` steps on the global batches 0..steps-1: the losses, the
    masters, the moments gathered whole, and what this rank holds."""
    cfg, z, state, step = dp_setup(arch, data, zero1, steps)
    held = {k: tuple(v.shape) for k, v in state.opt.mu.items()}
    losses = []
    for i in range(steps):
        state, metrics = step(state, batch_of(cfg, i))
        losses.append(float(metrics["loss"]))
    full = state if z is None else z.full(state)
    return {"losses": losses, "params": state.params, "mu": full.opt.mu,
            "nu": full.opt.nu, "held": held,
            "held_bytes": sum(4 * math.prod(s) for s in held.values()),
            "owned": None if z is None else {k: z.owned(k) for k in held}}


def launcher(argv: list) -> dict:
    """`repro_torch.launch.train.main` on this rank's group."""
    res = train_main(argv)
    return {k: res[k] for k in ("losses", "final_step", "ranks", "opt_bytes",
                                "opt_bytes_total")} | {
        "params": res["state"].params, "ef": res.get("ef"), "step": int(res["state"].step)}


def ft_agree(ckpt_dir: str, poison_step: int, stop_step: int) -> dict:
    """The fault-tolerant driver over ranks: rank 1 alone sees a NaN loss
    on ``poison_step`` (before the mean over ranks) and alone asks to stop
    after ``stop_step``; every rank must roll back, and stop, alike."""
    cfg, z, state, step = dp_setup("qwen3-14b", dist.get_world_size(), steps=8)
    rank, seen = dist.get_rank(), {"step": 0}
    real_mean = z.mean

    def mean(x):
        if rank == 1 and seen["step"] == poison_step:
            x = x * float("nan")
        return real_mean(x)
    z.mean = mean

    def step_fn(st, batch):
        seen["step"] += 1
        return step(st, batch)

    def hook(completed, st):
        if rank == 1 and completed == stop_step:
            driver.request_stop()
    driver = FaultTolerantDriver(step_fn, state, FTConfig(
        ckpt_dir=ckpt_dir, ckpt_every=2, handle_signals=False, step_hook=hook), ranks=z)
    res = driver.run(((i, batch_of(cfg, i)) for i in range(20)), total_steps=8)
    return {k: res[k] for k in ("losses", "rollbacks", "final_step", "stopped")}
