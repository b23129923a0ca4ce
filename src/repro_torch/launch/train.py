"""Training launcher (`repro/launch/train.py`) on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --batch 4 --seq 512 --steps 8 --ckpt-dir ckpt [--device cpu --reduced]

Builds the model on CUDA unless ``--device cpu`` is given (and raises when
CUDA is asked for and missing), its weights random from seed 0 in f32;
takes f32 masters from them (`train_init`), moves the model itself to
the meta device (the step runs it on the masters' cast), and runs bf16-compute steps
(`make_train_step`) under the fault-tolerant driver (periodic
checkpoints, NaN rollback, checkpoint-on-signal, resume from the latest
checkpoint in ``--ckpt-dir``).  Returns the reference's result dict:
losses, rollbacks, final_step, stopped, p95_s (and, with ``--runtime``,
telemetry and slot_budget), and the final `TrainState` under "state".

``--runtime`` shadow-dispatches each step's per-layer projection GEMM
bundle at M = batch·seq tokens through the online runtime.  On one
device there is nothing to derate: the reference's ``set_mesh`` on a
1×1 mesh gives the whole chip (frac 1.0) and a slot budget of the
controller's ``max_cd``, which is the port's runtime as it is made.
``--mesh`` and ``--compress-grads`` are distribution, ROADMAP A13: they
raise.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataLoader
from repro_torch.dist.fault_tolerance import FaultTolerantDriver, FTConfig
from repro_torch.models import build_model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import Runtime, decode_step_requests
from repro_torch.train.train_loop import make_train_step, train_init

DEFAULT_CKPT_DIR = str(Path(tempfile.gettempdir()) / "repro_torch_train_ckpt")


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
                    help="a device mesh: distribution, not ported (ROADMAP A13)")
    ap.add_argument("--runtime", action="store_true",
                    help="shadow-dispatch each step's GEMMs via repro_torch.runtime")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="gradient compression: distribution, not ported "
                         "(ROADMAP A13)")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh or args.compress_grads:
        raise NotImplementedError(
            f"{'--mesh' if args.mesh else '--compress-grads'} is distribution, "
            "which the port has not yet (ROADMAP A13); train on one device")

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device, dtype=torch.float32, seed=0)
    opt = AdamW(AdamWConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 5)))
    state = train_init(model, opt)
    model.to("meta")   # the step reads the masters alone: free the model's copy
    n_params = sum(p.numel() for p in state.params.values())
    step_fn = make_train_step(model, opt, n_microbatches=args.microbatches)

    runtime, step_requests = None, []
    if args.runtime:
        runtime = Runtime(device=device)
        # One training step's per-layer projection GEMMs see M = B·T
        # tokens; the bundle is shape-static, so derive it once.
        step_requests = decode_step_requests(runtime.ctrl, cfg, args.batch * args.seq)
        runtime.prewarm([r.desc for r in step_requests])
        print(f"[train] runtime on one device: slot_budget={runtime.available} "
              f"(max_cd {runtime.ctrl.max_cd}, no derating)")

    def train_step(st, batch):
        if runtime is not None:
            for r in step_requests:
                runtime.submit(r, tenant=cfg.name)
            runtime.flush(force=True)
        st, metrics = step_fn(st, batch)
        if args.log_every and int(st.step) % args.log_every == 0:
            print(f"[train] step {int(st.step)}: loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['gnorm']):.3f} lr {float(metrics['lr']):.3g}")
        return st, metrics

    driver = FaultTolerantDriver(train_step, state, FTConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every))
    start = driver.maybe_restore()
    print(f"[train] {cfg.name} on {device}: {n_params:,} params, "
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
    result["state"] = driver.state
    return result


if __name__ == "__main__":
    main()
