"""The readings that a cell's limits are set from: for each seed, one job of
the program at the cell's own size with its compared numbers (the sound
reading), and the same numbers with the plain references computed in TF32
put in the program's place (the control, which has to fail). On the card:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... [--out FILE]

prints one JSON row a seed and a summary (the largest sound reading and the
smallest control reading of each number). The benchmark's own runs do not
run this.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import load_cell  # noqa: E402


def summary(rows: list) -> dict:
    """{number: {"sound_max": ..., "control_min": ...}} over the rows."""
    out = {}
    for key in rows[0]:
        if key == "seed" or key.endswith("_control"):
            continue
        vals = [r[key] for r in rows]
        out[key] = {"sound_max": max(vals), "sound_min": min(vals)}
        ctl = f"{key}_control"
        if ctl in rows[0]:
            out[key]["control_min"] = min(r[ctl] for r in rows)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import importlib

    import torch

    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    driver = importlib.import_module(f"benchmark.kinds.{cell['traffic']['kind']}")
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        row = driver.readings(cell, [seed], device)[0]
        print(json.dumps(row), flush=True)
        rows.append(row)
    summ = summary(rows)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "summary": summ}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summ}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
