"""Read the compared numbers of one cell over many seeds in one process, for
the program or for the control (the reference in the next lower precision
in the program's place), to set the limits from.

    python -m benchmark.readings --workload <name> --side program|control \\
        --seeds 11,12,13 [--seconds 2]

Each seed is a whole run of the cell with a short window (set-up from the
seed, the window, the comparison); one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import time

from benchmark import run as run_lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control"),
                    default="program")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device")
        return run_lib.EXIT_NO_CARD
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = harness.run_cell(args.workload, seed, args.seconds, False,
                                  t0, torch.device("cuda", 0),
                                  side=args.side)
        print(json.dumps(run_lib.finite({
            "workload": args.workload, "side": args.side, "seed": seed,
            **{k: c["value"] for k, c in result["checks"].items()},
            "frames_per_s": result["window"]["frames"]
            / result["window"]["seconds"],
            "seconds": time.perf_counter() - t0})), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
