"""Measured-time harness for the GO pipeline (`repro/core/measure.py`).

The paper picks GO kernels from profiled concurrent runs; the tuner ranks
candidates with the analytical model.  This module times the launches
themselves, through the same launch shapes and family adapters the
scheduler dispatches (`core.scheduler.execute_schedule`), so a measured
number belongs to exactly the kernel a plan would run.

Backends (`backend_tag`): on the card (``"cuda-<device name>"``) each
sample is a pair of CUDA events on the current stream around the
launch — a ``mixed`` group's side streams join that stream before the
end event is recorded — synchronized before the next sample; on the CPU
(``"cpu"``) each sample is the injectable ``clock`` around the plain
versions, whose timings rank candidates only and say nothing of the
card.

Discipline per measurement:

- operands are synthesized once per request (`synth_request`, seeded, on
  the Measurer's device), and the first ``warmup`` samples are
  discarded (build, first-launch and cache effects);
- one wild sample cannot skew the result: samples beyond ``outlier_k``
  robust deviations are rejected, then the median of the survivors is
  reported (median-of-k);
- a watchdog records a sample longer than ``deadline_s`` as ``inf`` and
  counts it as a hang.

`Measurement.run_id` is a timestamp-free id (a hash of the work and the
harness settings), so measured GO-library entries (schema v5,
`core/library.py`) stay byte-stable across reruns.

    python -m repro_torch.core.measure --cells 4              # on the card
    python -m repro_torch.core.measure --cells 4 --device cpu
"""
from __future__ import annotations

import argparse
import hashlib
import math
import statistics
import sys
import time
from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Sequence

import torch

from repro_torch.core.cost_model import DEFAULT_SPEC, RC_FRACTIONS, TPUSpec
from repro_torch.core.device import resolve_device
from repro_torch.core.gemm_desc import TORCH_DTYPES, GemmDesc
from repro_torch.core.op_desc import family_of
from repro_torch.core.scheduler import (
    GemmRequest,
    GroupPlan,
    Schedule,
    execute_schedule,
)
from repro_torch.core.tuner import tune_gemm, tune_rc
from repro_torch.kernels.gemm.ops import TileConfig


def backend_tag(device="cuda") -> str:
    """Backend id persisted with measured entries: ``"cuda-<device
    name>"`` on the card, ``"cpu"`` for the plain versions on the CPU,
    whose timings rank candidates only.  Raises when ``device`` names
    CUDA and there is none."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda-{torch.cuda.get_device_name(dev)}"
    return dev.type


@dataclass(frozen=True)
class Measurement:
    """One measured launch: median-of-k seconds + provenance."""

    time_s: float
    samples: tuple          # kept post-warmup samples, seconds
    n: int                  # number of kept samples (after rejection)
    backend: str
    run_id: str
    hangs: int = 0          # timed samples that blew the watchdog deadline

    @property
    def finite(self) -> bool:
        return math.isfinite(self.time_s) and self.time_s > 0.0


def reject_outliers(samples: Sequence[float], k: float = 4.0) -> List[float]:
    """Drop samples farther than ``k`` robust deviations from the median.

    The deviation scale is ``max(MAD, 5% of median)``: the relative floor
    keeps an all-identical sample set (MAD = 0) from rejecting
    everything."""
    vals = list(samples)
    if len(vals) <= 2:
        return vals
    med = statistics.median(vals)
    mad = statistics.median(abs(v - med) for v in vals)
    scale = max(mad, 0.05 * abs(med))
    if scale <= 0.0:
        return vals
    kept = [v for v in vals if abs(v - med) <= k * scale]
    return kept or [med]


def synth_request(desc, seed: int = 0, device="cuda") -> GemmRequest:
    """Random operands for a descriptor of a ported family, drawn from a
    `torch.Generator` seeded with ``seed`` on ``device``, in the shapes
    and dtypes the reference's harness gives them (`_run_op`'s
    positional order).  Batched GEMMs have no execute path and raise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    fam = family_of(desc)
    if fam == "gemm":
        if desc.batch != 1:
            raise ValueError(
                "B-GEMMs have no grouped execute path yet (shadow-only); "
                f"cannot measure {desc.key()}")
        dt = TORCH_DTYPES[desc.dtype]
        a_shape = (desc.K, desc.M) if desc.ta else (desc.M, desc.K)
        b_shape = (desc.N, desc.K) if desc.tb else (desc.K, desc.N)
        a = randn(a_shape, dt)
        return GemmRequest(desc=desc, a=a, b=randn(b_shape, dt))
    if fam == "flash_attention":
        dt = torch.bfloat16 if desc.dtype == "bf16" else torch.float32
        q = randn((desc.B, desc.Hq, desc.Sq, desc.D), dt)
        k = randn((desc.B, desc.Hkv, desc.Skv, desc.D), dt)
        v = randn((desc.B, desc.Hkv, desc.Skv, desc.D), dt)
        return GemmRequest(desc=desc, inputs=(q, k, v))
    if fam == "mamba_scan":
        # The scan stages everything in f32 (op_desc.ScanDesc).
        f32 = torch.float32
        xd = randn((desc.B, desc.T, desc.H, desc.P), f32)
        da = randn((desc.B, desc.T, desc.H), f32).abs_().neg_()
        Bm = randn((desc.B, desc.T, desc.H, desc.N), f32)
        Cm = randn((desc.B, desc.T, desc.H, desc.N), f32)
        return GemmRequest(desc=desc, inputs=(xd, da, Bm, Cm))
    raise ValueError(f"no measurement path for the {fam} family")


def schedule_for(desc, tile: TileConfig, cd: int = 1) -> Schedule:
    """The one-group `Schedule` the scheduler would emit for ``cd``
    identical copies of ``desc`` at ``tile``: a grouped launch for plain
    GEMMs, a per-member mixed launch for the other families, single
    below CD 2.  Modeled time is 0: this schedule exists to be timed."""
    if cd <= 1:
        mode = "single"
    elif family_of(desc) == "gemm":
        mode = "grouped"
    else:
        mode = "mixed"
    gp = GroupPlan(
        indices=list(range(max(cd, 1))), cd=max(cd, 1), tile=tile,
        mode=mode, modeled_time_s=0.0,
        tiles=[tile] * cd if mode == "mixed" else None)
    return Schedule(groups=[gp])


def _run_key(desc_keys, tiles, cd, backend, warmup, repeats, seed) -> str:
    blob = "|".join([
        ",".join(desc_keys),
        ",".join(t.key() for t in tiles),
        str(cd), backend, str(warmup), str(repeats), str(seed),
    ])
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


class Measurer:
    """The timing harness on ``device`` (CUDA unless the caller passes
    ``device="cpu"``; raises without it).  ``clock`` times the CPU
    samples and is injectable: the tests script it to check warmup
    exclusion, outlier rejection and the watchdog without real sleeps."""

    def __init__(
        self,
        spec: TPUSpec = DEFAULT_SPEC,
        *,
        warmup: int = 1,
        repeats: int = 5,
        device="cuda",
        clock=time.perf_counter,
        outlier_k: float = 4.0,
        seed: int = 0,
        deadline_s: float | None = None,
    ):
        self.spec = spec
        self.warmup = max(0, int(warmup))
        self.repeats = max(1, int(repeats))
        self.device = resolve_device(device)
        self.clock = clock
        self.outlier_k = float(outlier_k)
        self.seed = int(seed)
        self.backend = backend_tag(self.device)
        # Watchdog: a timed sample longer than the deadline is recorded
        # as ``inf``; MAD rejection discards a minority of hangs, and an
        # all-hung launch yields a non-finite median that
        # `Measurement.finite` (and the CLI) flags.
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.hangs = 0          # cumulative across this Measurer's calls

    # ------------------------------------------------------------ timing
    def _sample(self, requests, sched) -> float:
        """Seconds of one run of ``sched``: CUDA events on the current
        stream on the card, ``clock`` on the CPU."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = execute_schedule(requests, sched)
            end.record()
            end.synchronize()
            _check_ran(outs)
            return start.elapsed_time(end) * 1e-3
        t0 = self.clock()
        _check_ran(execute_schedule(requests, sched))
        return self.clock() - t0

    def measure_schedule(
        self, requests: Sequence[GemmRequest], sched: Schedule,
    ) -> Measurement:
        """Time one schedule: ``warmup`` discarded samples, then
        ``repeats`` timed ones; the outlier-rejected median of those."""
        for r in requests:
            ops = r.operands
            if ops is None or any(t is None for t in ops):
                raise ValueError(
                    "shadow request (no operands) cannot be measured — "
                    "synthesize operands via synth_request()")
            if any(t.device != self.device for t in ops):
                raise ValueError(f"{r.desc.key()}: operands on "
                                 f"{ops[0].device}, Measurer on {self.device}")
        samples: List[float] = []
        for _ in range(self.warmup + self.repeats):
            dt = self._sample(requests, sched)
            if self.deadline_s is not None and dt > self.deadline_s:
                dt = math.inf   # watchdog: hung sample, see __init__
            samples.append(dt)
        timed = samples[self.warmup:]
        hangs = sum(1 for v in timed if math.isinf(v))
        self.hangs += hangs
        kept = reject_outliers(timed, self.outlier_k)
        gp = sched.groups[0]
        run_id = _run_key(
            [r.desc.key() for r in requests],
            [gp.tile], gp.cd, self.backend,
            self.warmup, self.repeats, self.seed)
        return Measurement(
            time_s=float(statistics.median(kept)), samples=tuple(kept),
            n=len(kept), backend=self.backend, run_id=run_id,
            hangs=hangs)

    def measure_group(self, desc, tile: TileConfig, cd: int = 1) -> Measurement:
        """Measure ``cd`` concurrent copies of ``desc`` at ``tile``, each
        with operands of its own, in the scheduler's launch shape."""
        reqs = [synth_request(desc, seed=self.seed + i, device=self.device)
                for i in range(max(cd, 1))]
        return self.measure_schedule(reqs, schedule_for(desc, tile, cd))

    def measure_entry(
        self, desc, entry, cds: Sequence[int] | None = None,
    ) -> Dict[int, Measurement]:
        """Measured time of a GO-library entry's picks: the isolated tile
        at CD 1 plus each tuned CD's GO tile at that CD."""
        cds = sorted(entry.go) if cds is None else sorted(cds)
        out = {1: self.measure_group(desc, entry.isolated, 1)}
        for cd in cds:
            if cd <= 1:
                continue
            out[cd] = self.measure_group(desc, entry.tile_for_cd(cd), cd)
        return out

    # ----------------------------------------------------------- re-rank
    def rerank(self, desc, entry, cds: Sequence[int] | None = None):
        """Measured re-rank of the Step-② candidates (the `tune_gemm(...,
        measure=)` / `tune_op(..., measure=)` hook).

        Per CD the candidates are the modeled pick, the other CDs' picks,
        the isolated tile and (plain GEMMs) the re-derived Step-① RC
        winners, each measured as the launch the scheduler would emit;
        the measured-fastest wins, a tie keeping the earlier candidate.
        Returns a new `GOEntry` carrying ``measured`` times and the
        backend, sample count and run id (schema v5); the modeled
        speedups are kept, so measured and modeled stay comparable."""
        cds = sorted(entry.go) if cds is None else sorted(int(c) for c in cds)
        rc_winners: Dict[str, TileConfig] = {}
        if family_of(desc) == "gemm" and getattr(desc, "batch", 1) == 1:
            rc_winners = {
                name: tune_rc(desc, frac, self.spec)
                for name, frac in RC_FRACTIONS.items()
            }
        iso = self.measure_group(desc, entry.isolated, 1)
        measured: Dict[int, float] = {1: iso.time_s}
        new_go = dict(entry.go)
        new_src = dict(entry.rc_source)
        for cd in cds:
            if cd <= 1:
                continue
            cands: List[tuple[str, TileConfig]] = [
                (entry.rc_source.get(cd, "model"), entry.tile_for_cd(cd))
            ]
            for c, t in sorted(entry.go.items()):
                if c != cd:
                    cands.append((entry.rc_source.get(c, "model"), t))
            cands.append(("GPU", entry.isolated))
            cands += sorted(rc_winners.items())
            seen, uniq = set(), []
            for name, t in cands:
                if t not in seen:
                    seen.add(t)
                    uniq.append((name, t))
            best_name, best_tile, best = None, None, math.inf
            for name, t in uniq:
                m = self.measure_group(desc, t, cd)
                if m.time_s < best:        # strict: ties keep the modeled pick
                    best_name, best_tile, best = name, t, m.time_s
            new_go[cd] = best_tile
            new_src[cd] = best_name
            measured[cd] = best
        return dc_replace(
            entry, go=new_go, rc_source=new_src, measured=measured,
            measure_backend=self.backend, measure_samples=self.repeats,
            measure_run_id=_run_key(
                [desc.key()], [entry.isolated], 0, self.backend,
                self.warmup, self.repeats, self.seed))


def _check_ran(outs) -> None:
    if all(o is None for o in outs):
        raise ValueError(
            "nothing executed — requests carry no operands "
            "(shadow dispatch cannot be measured)")


# --------------------------------------------------------------- CLI smoke
def smoke_grid(cells: int = 4) -> List[GemmDesc]:
    """Deterministic small-GEMM grid of decode-like shapes, each timed in
    well under a second on either backend."""
    shapes = [(8, 128, 128), (8, 256, 128), (16, 128, 256), (16, 256, 256),
              (32, 128, 128), (64, 128, 128), (8, 128, 256), (16, 128, 128)]
    return [GemmDesc(m, n, k, dtype="f32") for m, n, k in shapes[:cells]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="measurement smoke: time a small GEMM grid through the "
        "harness at CD 1 and --cd, and fail on a non-finite or zero timing")
    ap.add_argument("--cells", type=int, default=4)
    ap.add_argument("--cd", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, CUDA events) or cpu (the plain "
                    "versions, host clock; ranks candidates only)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-sample watchdog deadline; over-deadline "
                    "samples count as hangs and are reported")
    args = ap.parse_args(argv)

    deadline_s = None if args.deadline_ms is None else args.deadline_ms * 1e-3
    measurer = Measurer(warmup=args.warmup, repeats=args.repeats,
                        device=args.device, deadline_s=deadline_s)
    bad = 0
    print(f"# backend={measurer.backend} warmup={args.warmup} "
          f"repeats={args.repeats} deadline_ms={args.deadline_ms}")
    print(f"{'desc':24} {'cd':>3} {'measured_us':>12} {'n':>3} "
          f"{'hangs':>5}  run_id")
    for desc in smoke_grid(args.cells):
        entry = tune_gemm(desc)
        for cd in (1, args.cd):
            m = measurer.measure_group(desc, entry.tile_for_cd(cd), cd)
            flag = "" if m.finite else "  <-- NOT FINITE/ZERO"
            print(f"{desc.key():24} {cd:>3} {m.time_s * 1e6:>12.1f} "
                  f"{m.n:>3} {m.hangs:>5}  {m.run_id}{flag}")
            if not m.finite:
                bad += 1
    print(f"# hangs={measurer.hangs}")
    if bad:
        print(f"measure-smoke: {bad} non-finite or zero timing(s)")
        return 1
    print("# measure-smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
