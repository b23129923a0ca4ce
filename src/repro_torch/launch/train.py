"""Training launcher (`repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --batch 4 --seq 512 --steps 8 --ckpt-dir ckpt [--device cpu --reduced]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen3-14b --reduced --device cpu --mesh 2x1 --compress-grads

Builds the model on CUDA unless ``--device cpu`` is given (and raises when
CUDA is asked for and missing), its weights random from seed 0 in f32;
takes f32 masters from them (`train_init`), moves the model itself to
the meta device (the step runs it on the masters' cast), and runs bf16-compute steps
(`make_train_step`) under the fault-tolerant driver (periodic
checkpoints, NaN rollback, checkpoint-on-signal, resume from the latest
checkpoint in ``--ckpt-dir``).  Returns the reference's result dict:
losses, rollbacks, final_step, stopped, p95_s (and, with ``--runtime``,
telemetry and slot_budget), the final `TrainState` under "state" (and
the error-feedback buffers under "ef" with ``--compress-grads``).

``--mesh DxM`` trains data parallel over D ranks with ZeRO-1 optimizer
state (`dist/zero1.py`): under torchrun (its env rendezvous; one rank
per card on CUDA, NCCL; gloo on the CPU), or, for ``1x1`` outside
torchrun, on a group of this process alone.  The world must hold D·M
ranks; M > 1 is training on the model axis, ROADMAP A13c, and raises.  The
result adds "ranks", "opt_bytes" (this rank's moments) and
"opt_bytes_total".  ``--compress-grads`` compresses the mean gradient
(int8 with error feedback, `dist/compress.py`); the error-feedback
buffers are carried with the state and checkpointed with it.

``--runtime`` shadow-dispatches each step's per-layer projection GEMM
bundle at M = batch·seq tokens through the online runtime, derated by
`Runtime.set_mesh` to the mesh (a 1×1 one without ``--mesh``), and
reports the runtime's own slot budget.
"""
from __future__ import annotations

import argparse
import re
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataLoader
from repro_torch.dist.compress import compress_grads, ef_init
from repro_torch.dist.fault_tolerance import FaultTolerantDriver, FTConfig
from repro_torch.dist.zero1 import Zero1
from repro_torch.launch.mesh import MeshShape, Ranks, make_debug_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import Runtime, decode_step_requests
from repro_torch.train.train_loop import make_train_step, train_init

DEFAULT_CKPT_DIR = str(Path(tempfile.gettempdir()) / "repro_torch_train_ckpt")


def parse_mesh(text: str) -> tuple:
    """``"DxM"`` → (D, M), both positive."""
    m = re.fullmatch(r"([1-9][0-9]*)[xX]([1-9][0-9]*)", text)
    if m is None:
        raise ValueError(f"--mesh {text!r}: write it DxM with positive sizes, e.g. 2x1")
    return int(m[1]), int(m[2])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) config of the arch")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="data x model mesh over the ranks, e.g. 2x1: ZeRO-1 over "
                         "data (M > 1 is ROADMAP A13c)")
    ap.add_argument("--runtime", action="store_true",
                    help="shadow-dispatch each step's GEMMs via repro_torch.runtime "
                         "with the mesh-derated slot budget")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback compression of the mean gradient")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if not args.mesh:
        return _train(args, device, None)
    data, tp = parse_mesh(args.mesh)
    if tp > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: {tp} model shards: training on the model axis "
            "(autograd through the collectives, a vocab-parallel cross-entropy, ZeRO-1 "
            "with tensor parallelism) waits for ROADMAP A13c; use --mesh Dx1")
    if data > 1 and not (dist.is_initialized() or dist.is_torchelastic_launched()):
        raise RuntimeError(f"--mesh {args.mesh} needs {data} ranks: run it under "
                           f"torchrun --nproc-per-node {data}")
    with Ranks(device) as device:
        return _train(args, device, make_debug_mesh(data, tp, device=device))


def _train(args, device: torch.device, mesh) -> dict:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device, dtype=torch.float32, seed=0)
    opt = AdamW(AdamWConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 5)))
    zero1 = None if mesh is None else Zero1(model, mesh, device=device)
    state = train_init(model, opt, zero1)
    n_params = sum(p.numel() for p in state.params.values())
    kw = dict(n_microbatches=args.microbatches, zero1=zero1)
    if args.compress_grads:
        # The EF buffers are training state: carried beside the TrainState
        # and checkpointed with it.
        ef_box = {}

        def transform(g):
            gq, ef_box["ef"] = compress_grads(g, ef_box["ef"])
            return gq
        inner = make_train_step(model, opt, grad_transform=transform, **kw)

        def step_fn(carry, batch):
            ef_box["ef"] = carry[1]
            st, metrics = inner(carry[0], batch)
            return (st, ef_box.pop("ef")), metrics
        carry = (state, ef_init(state.params))
    else:
        step_fn = make_train_step(model, opt, **kw)
        carry = state
    model.to("meta")   # the step reads the masters alone: free the model's copy

    runtime, step_requests = None, []
    if args.runtime:
        runtime = Runtime(device=device)
        # the runtime's own derating is authoritative: report its budget
        res = runtime.set_mesh(mesh if mesh is not None else MeshShape(data=1, model=1))
        # One training step's per-layer projection GEMMs see M = B·T
        # tokens; the bundle is shape-static, so derive it once.
        step_requests = decode_step_requests(runtime.ctrl, cfg, args.batch * args.seq)
        runtime.prewarm([r.desc for r in step_requests])
        print(f"[train] runtime derated: model_shards={res.model_shards} "
              f"slot_budget={res.slot_budget} (max_cd {runtime.ctrl.max_cd})")

    def train_step(c, batch):
        if runtime is not None:
            for r in step_requests:
                runtime.submit(r, tenant=cfg.name)
            runtime.flush(force=True)
        c, metrics = step_fn(c, batch)
        step = int((c[0] if args.compress_grads else c).step)
        if args.log_every and step % args.log_every == 0:
            print(f"[train] step {step}: loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['gnorm']):.3f} lr {float(metrics['lr']):.3g}")
        return c, metrics

    driver = FaultTolerantDriver(train_step, carry, FTConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every), ranks=zero1)
    start = driver.maybe_restore()
    ranks = 1 if zero1 is None else zero1.world
    opt_state = (carry[0] if args.compress_grads else carry).opt
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in (*opt_state.mu.values(), *opt_state.nu.values()))
    print(f"[train] {cfg.name} on {device}: {n_params:,} params, ranks={ranks}, mesh="
          f"{None if mesh is None else zero1.shape}, optimizer bytes this rank "
          f"{opt_bytes:,} of {8 * n_params:,}, "
          f"cd_slots={runtime.available if runtime else 'off'}, start_step={start}")

    t0 = time.time()
    with DataLoader(cfg, InputShape("cli", args.seq, args.batch, "train")) as loader:
        result = driver.run(loader, args.steps, start_step=start)
    dt = time.time() - t0
    losses = result["losses"]
    if losses:
        print(f"[train] steps={result['final_step']} loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f} ({dt:.1f}s, p95 step {result['p95_s'] * 1e3:.0f}ms, "
              f"rollbacks={result['rollbacks']})")
    if runtime is not None:
        result["telemetry"] = runtime.telemetry.summary()
        result["slot_budget"] = runtime.available
        print(f"[train] runtime telemetry: {result['telemetry']}")
    result.update(ranks=ranks, opt_bytes=opt_bytes, opt_bytes_total=8 * n_params)
    if args.compress_grads:
        result["state"], result["ef"] = driver.state
    else:
        result["state"] = driver.state
    return result


if __name__ == "__main__":
    main()
