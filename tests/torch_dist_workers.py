"""Rank processes for the port's multi-rank CPU tests
(`tests/test_torch_zero1.py`, `tests/test_torch_tp.py`): gloo over a
file rendezvous, a short collective timeout, each rank's result saved
beside the rendezvous file.  Imports no JAX: every rank starts from a
fresh interpreter (spawn)."""
from __future__ import annotations

import dataclasses
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
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model, moe
from repro_torch.models.attention import gqa_apply, mla_apply
from repro_torch.models.common import embed_apply, lm_head_apply, mlp_apply
from repro_torch.models.convert import from_reference
from repro_torch.train.serve_loop import greedy_decode
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.train.train_loop import make_train_step, train_init

JOIN_S = 120          # each test's own limit on its ranks
COLLECTIVE_S = 60     # a hung collective fails instead of stalling


def spawn(tmp_path: Path, world: int, fn: str, **kw) -> list:
    """Run ``fn(**kw)`` on ``world`` gloo ranks; returns each rank's result.
    Fails if a rank fails or does not finish within JOIN_S."""
    return spawn_join(spawn_start(tmp_path, world, fn, **kw))


def spawn_start(tmp_path: Path, world: int, fn: str, **kw) -> tuple:
    """Start `spawn`'s ranks and return at once (`spawn_join` waits)."""
    ctx = multiprocessing.get_context("spawn")
    rdv, out = tmp_path / f"rdv-{fn}-{world}", tmp_path / f"out-{fn}-{world}"
    procs = [ctx.Process(target=_rank, args=(r, world, str(rdv), fn, kw, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, fn, out


def spawn_join(started: tuple) -> list:
    """Wait for `spawn_start`'s ranks; each rank's result."""
    procs, fn, out = started
    world = len(procs)
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
    z = Zero1(model, make_debug_mesh(data, 1, device="cpu"), device="cpu") if zero1 else None
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


# ------------------------------------------------------- the model axis
def tp_serve(inputs: str) -> dict:
    """`tests/test_torch_tp.py`'s checks on this rank of a (1, world)
    mesh: for each case of ``inputs`` (a reduced config's overrides, the
    reference's parameters as numpy, inputs from a seed) the sharded
    modules' outputs, greedy decoding, and the seeded shard's leaves;
    then the serve launcher on this group."""
    data = torch.load(inputs, weights_only=False)
    mesh = make_debug_mesh(1, dist.get_world_size(), device="cpu")
    out = {key: _tp_case(case, mesh) for key, case in data["cases"].items()}
    out["serve"] = [serve_main(argv) for argv in data["serve"]]
    return out


def _layer0(cache):
    return type(cache)(*(t[0] for t in cache))


@torch.inference_mode()
def _tp_case(case: dict, mesh) -> dict:
    cfg = dataclasses.replace(reduced(case["arch"]), **case["kw"])
    model = from_reference(build_model(cfg, device="cpu", seed=None, mesh=mesh),
                           case["params"])
    seeded = build_model(cfg, device="cpu", seed=0, mesh=mesh)
    res = {"layouts": {n: tuple(lay) for n, lay in model.layouts.items()},
           "seeded": dict(seeded.named_parameters()), "rank": model.tp.rank}
    x = torch.from_numpy(case["x"])
    B, T, _ = x.shape
    pos = torch.arange(T)[None].expand(B, T)
    if "attn" in case["checks"]:
        attn = model.layers[0].attn
        apply = mla_apply if cfg.attn_type == "mla" else gqa_apply
        cache = _layer0(model.init_cache(B, T + 2, torch.float32)["main"])
        y0, _ = apply(attn, x, cfg, pos)
        y1, cache = apply(attn, x, cfg, pos, cache=cache, cache_len=0)
        y2, cache = apply(attn, x[:, :1], cfg, pos[:, :1] + T, cache=cache, cache_len=T)
        res["attn"] = {"prefill": y0, "cached prefill": y1, "decode step": y2,
                       "cache": tuple(cache)}
    if "mlp" in case["checks"]:
        res["mlp"] = mlp_apply((model.dense_layers if cfg.family == "moe"
                                else model.layers)[0].mlp, x)
    if "vocab" in case["checks"]:
        res["embed"] = embed_apply(model.embed, torch.from_numpy(case["tokens"]))
        res["head"] = lm_head_apply(model.embed, x)
    if "moe" in case["checks"]:
        xm, layer = torch.from_numpy(case["xm"]), model.layers[0]
        res["ep"] = {cf: moe.moe_ep_apply(layer.moe, xm, cfg, model.tp, capacity_factor=cf)
                     for cf in case["cfs"]}
        res["capacity"] = {cf: moe.moe_capacity_apply(layer.moe, xm, cfg,
                                                      capacity_factor=cf)
                           for cf in case["cfs"]}
    if "greedy" in case["checks"]:
        prompt = torch.from_numpy(case["prompt"])
        logits, steps = [], case["steps"]
        moe.paths.clear()
        toks = greedy_decode(model, {"tokens": prompt}, s_max=prompt.shape[1] + steps + 1,
                             steps=steps, device="cpu", on_step=logits.append)
        res["greedy"] = {"tokens": toks, "logits": logits, "paths": dict(moe.paths)}
    return res
