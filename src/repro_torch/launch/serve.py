"""Serving launcher (`repro/launch/serve.py`): batched prefill and greedy
decode of one model over the ranks there are.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch qwen3-14b --reduced

As the reference's `:49-55`, the mesh always comes from the ranks
(`make_mesh_from_devices`: the largest model axis of 16, 8, 4, 2 or 1
that divides them; outside torchrun a group of this process alone) and
the model is built sharded on it (`Model(mesh=...)`): tensor-parallel
attention, MLPs and vocabulary, experts over `all_to_all` in the
prefill.  Under torchrun each rank takes its own card, over NCCL.  Every
rank decodes the same tokens; rank 0 prints.  Every registered
architecture builds (``--reduced``: its tiny same-family config); the
hybrid and ssm families serve on one rank only (ROADMAP A13d);
MusicGen's audio stub raises, as `greedy_decode` says why: its step
takes frames.  The model runs on CUDA unless ``--device cpu`` is given
(and the launcher raises when CUDA is asked for and missing); its
weights are random from seed 0, in float32, the reference's default.
``--runtime`` routes each decode step's GEMMs through the online
concurrency runtime in shadow dispatch and prints its telemetry
(``--mixed-ops``: the whole op bundle; ``--graph``: the step as a
dependency graph), the runtime derated to the mesh (`Runtime.set_mesh`),
as the reference's launcher does.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.mesh import Ranks, make_mesh_from_devices, mesh_shape
from repro_torch.models import build_model
from repro_torch.runtime import Runtime
from repro_torch.train.serve_loop import greedy_decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--runtime", action="store_true",
                    help="shadow-dispatch decode GEMMs via repro_torch.runtime")
    ap.add_argument("--mixed-ops", action="store_true",
                    help="with --runtime: co-schedule the full decode op "
                         "bundle (attention/MoE/scan + GEMMs) as one "
                         "heterogeneous group")
    ap.add_argument("--graph", action="store_true",
                    help="with --runtime: submit each decode step as a "
                         "dependency graph (QKV -> attention -> O-proj -> "
                         "FFN/MoE)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    with Ranks(resolve_device(args.device)) as device:
        return _serve(args, cfg, device)


def _serve(args, cfg, device: torch.device):
    mesh = make_mesh_from_devices(device)
    lead = dist.get_rank() == 0
    model = build_model(cfg, device=device, dtype=torch.float32, seed=0, mesh=mesh)
    shape = InputShape("serve", args.prompt_len, args.batch, "prefill")
    prompt = make_batch(cfg, shape, 0)
    prompt.pop("labels")
    runtime = None
    if args.runtime:
        runtime = Runtime(device=device)
        # Derate the available CD slots and the cost model's spec to the
        # per-shard fraction of the serving mesh.
        res = runtime.set_mesh(mesh)
        if lead:
            print(f"[serve] runtime derated for mesh={res.mesh_shape}: "
                  f"per-shard frac={res.frac:.2f} slot_budget={res.slot_budget}")

    t0 = time.perf_counter()
    toks = greedy_decode(
        model, prompt, s_max=args.prompt_len + args.gen + 1, steps=args.gen,
        runtime=runtime, tenant=cfg.name, mixed_ops=args.mixed_ops,
        graph=args.graph, device=device)
    first = toks[0].tolist()    # waits for the device
    dt = time.perf_counter() - t0
    if lead:
        print(f"[serve] {cfg.name} on {device}: mesh={mesh_shape(mesh)} batch={args.batch} "
              f"prompt={args.prompt_len} gen={args.gen} -> {tuple(toks.shape)} in "
              f"{dt:.1f}s ({args.batch * args.gen / dt:.1f} tok/s)")
        print("first sequence:", first)
        if runtime is not None:
            print(f"[serve] runtime telemetry: {runtime.telemetry.summary()}")
    return toks


if __name__ == "__main__":
    main()
