"""GO library, paper §4.2.2 (`repro/core/library.py`).

Maps an op (a GEMM, an attention or an SSD-scan descriptor) to its
isolated-tuned tile and, per concurrency degree, its
globally-optimized (GO) tile.  The on-disk format is the reference's
schema-v5 JSON, read and written unchanged, so both packages plan from
the same entries (`results/golib.json` loads into either):

- a bare v1 blob's entries were tuned on a pre-split-K space and are
  discarded with a warning (re-tuned lazily);
- v2–v4 entries are kept bitwise (short tile lists default
  ``split_k=1``/``stream_k=0``), with a warning that the next `save`
  rewrites the file at v5;
- a corrupt or wrong-type file warns and leaves the library empty.

The runtime's self-correction edits a live library: `invalidate` drops
entries so the next `get` or `prewarm` re-tunes them (the drift re-tunes,
DESIGN.md §16), and `quarantine` bans a GO tile for some entries until
`release` (the circuit breaker, §18.3).  Quarantine is not saved.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from dataclasses import replace
from pathlib import Path
from typing import Dict, FrozenSet, Optional, Sequence

from repro_torch.core.cost_model import DEFAULT_SPEC, TPUSpec
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.tuner import GOEntry, tune_gemm, tune_gemm_batch, tune_op
from repro_torch.kernels.gemm.ops import TileConfig

SCHEMA_VERSION = 5


def _tile_to_list(t: TileConfig) -> list[int]:
    return [t.bm, t.bn, t.bk, t.split_k, t.stream_k]


def _tile_from_list(v) -> TileConfig:
    return TileConfig(*v)


class GOLibrary:
    """Thread-safe, lazily-tuned, optionally disk-backed kernel library."""

    def __init__(
        self,
        path: str | os.PathLike | None = None,
        spec: TPUSpec = DEFAULT_SPEC,
    ):
        self.path = Path(path) if path else None
        self.spec = spec
        self._entries: Dict[str, GOEntry] = {}
        self._lock = threading.Lock()
        self.loaded_schema: Optional[int] = None
        # per desc key, the tile keys the circuit breaker has banned; not
        # persisted: quarantine reflects live failures on this process's
        # device, not a property of the tuned library
        self._quarantine: Dict[str, set] = {}
        if self.path and self.path.exists():
            self.load(self.path)

    # -------------------------------------------------------------- access
    def get(self, desc) -> GOEntry:
        """GO entry of any ported family: GEMMs take `tune_gemm`, other
        families `tune_op`.  Entries leave through the quarantine filter
        (`_sanitize`), so no caller is handed a banned tile."""
        key = desc.key()
        with self._lock:
            e = self._entries.get(key)
        if e is None:
            e = (tune_gemm(desc, self.spec) if isinstance(desc, GemmDesc)
                 else tune_op(desc, self.spec))
            with self._lock:
                e = self._entries.setdefault(key, e)
        return self._sanitize(key, e)

    def tile(self, desc, cd: int = 1) -> TileConfig:
        """The tile ``desc`` runs at in a group of ``cd`` (its GO tile)."""
        return self.get(desc).tile_for_cd(cd)

    def prewarm(self, descs: Sequence) -> int:
        """Tune ahead of traffic: missing GEMMs in ONE `tune_gemm_batch`
        sweep, other families through `tune_op` per descriptor; returns
        the number of newly tuned entries (saved when disk-backed)."""
        with self._lock:
            missing = {d.key(): d for d in descs if d.key() not in self._entries}
        if missing:
            entries = tune_gemm_batch(
                [d for d in missing.values() if isinstance(d, GemmDesc)],
                self.spec)
            entries += [tune_op(d, self.spec) for d in missing.values()
                        if not isinstance(d, GemmDesc)]
            with self._lock:
                for e in entries:
                    self._entries.setdefault(e.desc_key, e)
        if missing and self.path:
            self.save()
        return len(missing)

    def invalidate(self, keys: Sequence[str]) -> int:
        """Drop entries by desc key so the next `get` or `prewarm` re-tunes
        them; returns the number dropped."""
        n = 0
        with self._lock:
            for k in keys:
                if self._entries.pop(k, None) is not None:
                    n += 1
        return n

    def quarantine(self, keys: Sequence[str], tile_key: str) -> None:
        """Ban ``tile_key`` for these desc keys: `get` gives the isolated
        tile in its place and drops its speedup claim, so the oracle's CD
        stops trusting it, until `release`."""
        with self._lock:
            for k in keys:
                self._quarantine.setdefault(k, set()).add(tile_key)

    def release(self, keys: Sequence[str], tile_key: str) -> None:
        """Lift a quarantine (the breaker's half-open probe)."""
        with self._lock:
            for k in keys:
                s = self._quarantine.get(k)
                if s is not None:
                    s.discard(tile_key)
                    if not s:
                        del self._quarantine[k]

    def quarantined(self) -> Dict[str, FrozenSet[str]]:
        with self._lock:
            return {k: frozenset(s) for k, s in self._quarantine.items()}

    def _sanitize(self, key: str, e: GOEntry) -> GOEntry:
        """One entry through the quarantine set: banned GO tiles become the
        isolated tile and lose their speedup.  The isolated tile itself is
        never replaced: it is the ladder's legacy rung."""
        banned = self._quarantine.get(key)
        if not banned:
            return e
        go = {cd: (e.isolated if t.key() in banned else t)
              for cd, t in e.go.items()}
        speedup = {cd: s for cd, s in e.speedup.items()
                   if e.go[cd].key() not in banned}
        if go == e.go and speedup == e.speedup:
            return e
        return replace(e, go=go, speedup=speedup)

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> Dict[str, GOEntry]:
        return dict(self._entries)

    # ----------------------------------------------------------- persist
    def save(self, path: str | os.PathLike | None = None) -> None:
        path = Path(path or self.path)

        def _rec(e: GOEntry) -> dict:
            rec = {
                "family": e.family,
                "isolated": _tile_to_list(e.isolated),
                "go": {str(cd): _tile_to_list(t) for cd, t in e.go.items()},
                "rc_source": e.rc_source,
                "speedup": {str(cd): s for cd, s in e.speedup.items()},
            }
            if e.measured:
                rec["measured"] = {str(cd): t for cd, t in e.measured.items()}
                rec["measure"] = {
                    "backend": e.measure_backend,
                    "samples": e.measure_samples,
                    "run_id": e.measure_run_id,
                }
            return rec

        blob = {
            "schema": SCHEMA_VERSION,
            "entries": {k: _rec(e) for k, e in self._entries.items()},
        }
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(blob, separators=(",", ":")))
        tmp.replace(path)

    def load(self, path: str | os.PathLike) -> int:
        """Parse a v1–v5 blob; returns the file's schema version (0 when
        the file is unusable)."""
        def _unusable(why: str) -> int:
            warnings.warn(
                f"GO library {path} is unusable ({why}); starting with an "
                "empty library — entries re-tune lazily and the next save "
                "rewrites the file.", stacklevel=3)
            self.loaded_schema = None
            return 0

        try:
            blob = json.loads(Path(path).read_text())
        except (OSError, UnicodeDecodeError, ValueError) as e:
            return _unusable(f"{type(e).__name__}: {e}")
        if isinstance(blob, dict) and "schema" in blob:
            try:
                schema = int(blob["schema"])
            except (TypeError, ValueError):
                return _unusable(f"non-integer schema {blob['schema']!r}")
            entries = blob.get("entries")
        else:
            schema, entries = 1, blob           # bare v1 mapping
        if not isinstance(entries, dict):
            return _unusable(
                f"entries is {type(entries).__name__}, expected mapping")
        self.loaded_schema = schema
        if schema < 2:
            warnings.warn(
                f"GO library {path} has stale schema v{schema} (< "
                f"v{SCHEMA_VERSION}); discarding {len(entries)} entries — "
                "they will be re-tuned on the current search space.",
                stacklevel=2,
            )
            return schema
        if schema < SCHEMA_VERSION:
            warnings.warn(
                f"GO library {path} has schema v{schema} (< "
                f"v{SCHEMA_VERSION}); migrating {len(entries)} entries "
                "in place (GEMM family default) — the next save rewrites "
                f"the file at v{SCHEMA_VERSION}.",
                stacklevel=2,
            )
        bad = 0
        for k, v in entries.items():
            try:
                meta = v.get("measure", {})
                self._entries[k] = GOEntry(
                    desc_key=k,
                    isolated=_tile_from_list(v["isolated"]),
                    go={int(cd): _tile_from_list(t)
                        for cd, t in v["go"].items()},
                    rc_source={int(c): s
                               for c, s in v.get("rc_source", {}).items()},
                    speedup={int(c): s
                             for c, s in v.get("speedup", {}).items()},
                    family=v.get("family", "gemm"),
                    measured={int(c): float(t)
                              for c, t in v.get("measured", {}).items()},
                    measure_backend=meta.get("backend"),
                    measure_samples=int(meta.get("samples", 0)),
                    measure_run_id=meta.get("run_id"),
                )
            except (AttributeError, KeyError, TypeError, ValueError):
                bad += 1       # malformed record — skip, re-tune lazily
        if bad:
            warnings.warn(
                f"GO library {path}: skipped {bad} malformed entr"
                f"{'y' if bad == 1 else 'ies'} — they re-tune lazily.",
                stacklevel=2)
        return schema


_DEFAULT: Optional[GOLibrary] = None


def default_library() -> GOLibrary:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = GOLibrary()
    return _DEFAULT
