"""The graph windows of `chip_smoke.py`'s phase 7 in shadow mode on the
CPU: the port's planner alone, operand-free, at full width and depth
(Qwen3-14B: 40 layers, context 4,096; Zamba2-1.2B: 38 layers, context
2,048).  Prints, per window and run (graph cold, graph warm, waves), the
launches by mode, mean CD, flushes, cross-graph groups, ready-set depths
and plan-cache hits: the predictions the executed run on the card must
reproduce (`chip_smoke.graph_part` fails if its launches differ).  No
time it prints is a device time.

    PYTHONPATH=src python3 probes/graph_shadow/predict.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> None:
    for name, context in chip_smoke.OP_CONFIGS:
        cfg = chip_smoke.get_arch(name)
        layers = chip_smoke.OP_LAYERS.get(name, cfg.n_layers)
        for batches, available, run, sig, stats in chip_smoke.graph_shadow(
                cfg, context, layers, "cpu"):
            del stats["device_s"], stats["wall_s"]
            print(f"{name} {run} batches {batches} available {available}: "
                  f"{len(sig)} launches, {stats}")


if __name__ == "__main__":
    main()
