"""Deterministic fault injection and circuit breaking
(`repro/runtime/faults.py`, DESIGN.md §18).

The two primitives the runtime's fallback ladder
(`Runtime._execute_resilient`) is built on:

- `FaultInjector`: a seed-keyed chaos layer that wraps
  `core.scheduler.execute_schedule` and makes a deterministic subset of
  launches raise, return NaN, or stall.  Each decision is a pure function
  of (seed, rule, scope, ordinal), the scope being the launch's (family,
  compat-class, tile-key), so the same trace with the same seed faults
  the same launches, in either package.
- `CircuitBreaker`: per-(family, class, tile-key) consecutive-failure
  counts, quarantine after K strikes, and a half-open probe after a
  cooldown on the runtime's modeled timeline.

The failures the ladder handles are the `LaunchFault`s defined here and
`KernelLaunchError`, a kernel launch whose CUDA status is not 0.  A
"nan" injection replaces a member's output with a new tensor and never
writes in place: a ragged launch's outputs are views of one buffer.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.op_desc import family_of
from repro_torch.core.scheduler import compat_key, execute_schedule


class LaunchFault(RuntimeError):
    """Base class of the failures the fallback ladder handles besides a
    kernel's own launch error."""


class InjectedFault(LaunchFault):
    """A launch the `FaultInjector` decided should raise."""


class LaunchStall(LaunchFault):
    """A launch past its (simulated) deadline: the injector's stand-in for
    a hung kernel, raised after advancing the injectable clock."""


class NonFiniteOutput(LaunchFault):
    """A launch that completed with a NaN or an infinity in its output,
    injected or genuine."""


def fault_kind(exc: BaseException) -> str:
    """Telemetry bucket of one failure: injected kinds keep their names;
    anything else (a `KernelLaunchError`) is ``"error"``."""
    if isinstance(exc, LaunchStall):
        return "stall"
    if isinstance(exc, NonFiniteOutput):
        return "nan"
    if isinstance(exc, InjectedFault):
        return "raise"
    return "error"


@dataclass(frozen=True)
class FaultRule:
    """One chaos rule: fault probability ``p`` for launches matching the
    scope filters (``None`` matches anything).  ``kind`` is "raise",
    "nan" or "stall"; ``max_faults`` caps its deliveries."""

    kind: str
    p: float
    family: Optional[str] = None
    class_key: Optional[str] = None
    tile_key: Optional[str] = None
    stall_s: float = 2e-3
    max_faults: Optional[int] = None

    def matches(self, family: str, class_key: str, tile_key: str) -> bool:
        return ((self.family is None or self.family == family)
                and (self.class_key is None or self.class_key == class_key)
                and (self.tile_key is None or self.tile_key == tile_key))


@dataclass(frozen=True)
class Injection:
    """One delivered fault: the audit record `Telemetry.faults` reconciles
    with."""

    kind: str
    family: str
    class_key: str
    tile_key: str
    ordinal: int                    # per-scope attempt count at delivery


def _roll(seed: int, kind: str, scope: str, ordinal: int) -> float:
    """Uniform [0, 1) as a pure function of the decision's coordinates
    (sha1, so rolls are the same on every platform and in both
    packages)."""
    blob = f"{seed}|{kind}|{scope}|{ordinal}".encode()
    return int.from_bytes(hashlib.sha1(blob).digest()[:8], "big") / 2.0 ** 64


@dataclass
class FaultInjector:
    """Seed-keyed chaos layer over the executor (DESIGN.md §18.1).

    ``wrap(execute)`` returns a drop-in `execute_schedule` that rolls each
    group (each member of a ``mixed`` group, which carries per-member
    tiles) against the rules before executing: "raise" and "stall" abort
    the launch before any kernel runs; "nan" lets it run and then
    replaces the matched outputs with NaN tensors.  ``advance`` is the
    injectable-clock hook a stall calls with its duration.  The ladder's
    reference rung calls `execute_schedule` itself, never this wrapper."""

    rules: Sequence[FaultRule] = ()
    seed: int = 0
    advance: Optional[Callable[[float], None]] = None
    log: List[Injection] = field(default_factory=list)
    _ordinals: Dict[str, int] = field(default_factory=dict)
    _fired: Dict[int, int] = field(default_factory=dict)

    @property
    def enabled(self) -> bool:
        return any(r.p > 0.0 for r in self.rules)

    def decide(self, family: str, class_key: str, tile_key: str
               ) -> Optional[FaultRule]:
        """Roll one launch attempt against the rules; the first match
        wins.  Each scope keeps its own attempt ordinal, so a retry of the
        same (class, tile) rolls anew."""
        scope = f"{family}|{class_key}|{tile_key}"
        ordinal = self._ordinals.get(scope, 0)
        self._ordinals[scope] = ordinal + 1
        for idx, rule in enumerate(self.rules):
            if rule.p <= 0.0 or not rule.matches(family, class_key, tile_key):
                continue
            if (rule.max_faults is not None
                    and self._fired.get(idx, 0) >= rule.max_faults):
                continue
            if _roll(self.seed, rule.kind, scope, ordinal) < rule.p:
                self._fired[idx] = self._fired.get(idx, 0) + 1
                self.log.append(Injection(
                    kind=rule.kind, family=family, class_key=class_key,
                    tile_key=tile_key, ordinal=ordinal))
                return rule
        return None

    def _deliver(self, rule: FaultRule, poison: List[int],
                 targets: Sequence[int]) -> None:
        if rule.kind == "raise":
            raise InjectedFault("injected launch failure")
        if rule.kind == "stall":
            if self.advance is not None:
                self.advance(rule.stall_s)
            raise LaunchStall(
                f"injected stall exceeded deadline ({rule.stall_s:g}s)")
        poison.extend(targets)      # "nan": poisoned after execution

    def wrap(self, execute: Callable = execute_schedule) -> Callable:
        """The chaos-wrapped executor, with `execute_schedule`'s signature."""

        def run(requests, sched):
            if not self.enabled:
                return execute(requests, sched)
            poison: List[int] = []
            for gp in sched.groups:
                if gp.mode == "mixed":
                    tiles = gp.tiles or [gp.tile] * len(gp.indices)
                    for tile, i in zip(tiles, gp.indices):
                        d = requests[i].desc
                        rule = self.decide(family_of(d), compat_key(d),
                                           tile.key())
                        if rule is not None:
                            self._deliver(rule, poison, [i])
                else:
                    d = requests[gp.indices[0]].desc
                    rule = self.decide(family_of(d), compat_key(d),
                                       gp.tile.key())
                    if rule is not None:
                        self._deliver(rule, poison, gp.indices)
            outs = execute(requests, sched)
            for i in poison:
                if outs[i] is not None:
                    outs[i] = torch.full_like(outs[i], float("nan"))
            return outs

        return run


@dataclass
class _TileHealth:
    strikes: int = 0
    quarantined_at: Optional[float] = None


class CircuitBreaker:
    """Per-(family, compat-class, tile-key) quarantine (DESIGN.md §18.3).

    ``strike`` counts consecutive failures (a success on a healthy tile
    resets them); the K-th quarantines the tile and returns True exactly
    once, so the caller runs the eviction once.  ``release_due`` is the
    half-open probe: after ``cooldown_s`` the tile is released with
    ``K - 1`` strikes, so its next failure quarantines it again and a
    success clears it."""

    def __init__(self, strikes: int = 3, cooldown_s: float = 0.5):
        self.strikes = max(1, int(strikes))
        self.cooldown_s = float(cooldown_s)
        self._state: Dict[Tuple[str, str, str], _TileHealth] = {}
        self.quarantine_count = 0

    @property
    def active(self) -> bool:
        return bool(self._state)

    def strike(self, family: str, class_key: str, tile_key: str,
               now: float) -> bool:
        key = (family, class_key, tile_key)
        st = self._state.setdefault(key, _TileHealth())
        if st.quarantined_at is not None:
            return False            # already out: its side effects ran
        st.strikes += 1
        if st.strikes >= self.strikes:
            st.quarantined_at = now
            self.quarantine_count += 1
            return True
        return False

    def succeed(self, family: str, class_key: str, tile_key: str) -> None:
        st = self._state.get((family, class_key, tile_key))
        if st is not None and st.quarantined_at is None:
            del self._state[(family, class_key, tile_key)]

    def is_quarantined(self, family: str, class_key: str,
                       tile_key: str) -> bool:
        st = self._state.get((family, class_key, tile_key))
        return st is not None and st.quarantined_at is not None

    def quarantined(self) -> List[Tuple[str, str, str]]:
        return sorted(k for k, st in self._state.items()
                      if st.quarantined_at is not None)

    def release_due(self, now: float) -> List[Tuple[str, str, str]]:
        """Quarantined tiles whose cooldown has elapsed by ``now``, each
        moved to the half-open state (one more failure quarantines it)."""
        out: List[Tuple[str, str, str]] = []
        for key, st in sorted(self._state.items()):
            if (st.quarantined_at is not None
                    and now - st.quarantined_at >= self.cooldown_s):
                st.quarantined_at = None
                st.strikes = self.strikes - 1
                out.append(key)
        return out
