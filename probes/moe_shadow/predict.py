"""DeepSeek-V2-Lite-16B's windows of `chip_smoke.py`'s phase 7 in shadow
mode on the CPU: the port's planner alone, operand-free, at full width and
depth it serves there (`chip_smoke.OP_LAYERS`: 14 of 27 layers, context
2,048).  Prints, per op-bundle window (cold and
warm plans) and per graph window and run (graph cold, graph warm, waves),
the launches by mode, mean CD and flushes, and the `ragged_matmul`
launches the grouped members make at their planned tiles (`ragged_chunks`
of each pool's rows packed to the tile's bm): the predictions the executed
run on the card must reproduce (`chip_smoke` fails if its graph launches
or any window's ragged launches differ).  Also the expert pools' GO
entries.  No time it prints is a device time.

    PYTHONPATH=src python3 probes/moe_shadow/predict.py
"""
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

NAME, CONTEXT = cs.MOE, 2048
LAYERS = cs.OP_LAYERS[NAME]


def bundle_windows(cfg) -> None:
    rt = cs.Runtime(cs.ConcurrencyController(), cs.RuntimeConfig(window_s=0.0),
                    device="cpu")
    for batches, available in cs.OP_WINDOWS:
        rt.set_available(available)
        for run in ("cold", "warm"):
            launches = []
            for _ in range(LAYERS):
                for ti, batch in enumerate(batches):
                    rt.submit([cs.bind_operands(d)
                               for d in cs.decode_step_op_descs(cfg, batch, CONTEXT)],
                              tenant=f"tenant{ti}")
                launches += rt.drain()
            modes = Counter(ln.plan.mode for ln in launches)
            cds = [ln.plan.cd for ln in launches]
            pools = Counter((tk.desc.key(), t.key(), cs.pool_launches(tk.desc, t.bm))
                            for ln in launches
                            for tk, t in zip(ln.tickets, ln.plan.tiles
                                             or [ln.plan.tile] * len(ln.tickets))
                            if tk.desc.family == "grouped_gemm")
            print(f"{NAME} op bundle {run} batches {batches} available {available}: "
                  f"{len(launches)} launches {dict(modes)}, mean CD "
                  f"{sum(cds) / len(cds):.4f}; ragged_matmul launches "
                  f"{cs.expected_ragged(launches)}; pools at tiles "
                  + ", ".join(f"{k} at {t} x{n} ({each} each)"
                              for (k, t, each), n in sorted(pools.items())))


def graph_windows(cfg) -> None:
    for batches, available, run, res in cs.graph_windows(
            cfg, CONTEXT, "cpu",
            lambda ti, b: cs.decode_step_graph(cfg, b, CONTEXT, layers=LAYERS),
            shadow=True):
        launches, stats = res[1], res[-1]
        del stats["device_s"], stats["wall_s"]
        print(f"{NAME} {run} batches {batches} available {available}: "
              f"{len(launches)} launches, ragged_matmul launches "
              f"{cs.expected_ragged(launches)}, {stats}")


def main() -> None:
    cfg = cs.get_arch(NAME)
    lib = cs.default_library()
    for batch in (1, 4, 8, 16):
        for d in cs.moe_pools(cfg, batch):
            e = lib.get(d)
            print(f"{d.key()}: isolated {e.isolated.key()}, preferred CD "
                  f"{e.preferred_cd()}, GO tiles "
                  f"{ {cd: t.key() for cd, t in sorted(e.go.items())} }")
    bundle_windows(cfg)
    graph_windows(cfg)


if __name__ == "__main__":
    main()
