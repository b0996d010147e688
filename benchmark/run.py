"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds the program (``tpubody_torch``).
With ``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics and the device trace's breakdown.  The
last line of standard output is the result, one JSON object; the numbers
compared with the reference, each beside its limit, are the last lines of
standard error and the last key of the result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "cache")
# Kernel caches live at fixed paths inside the checkout, so that only the
# first run of a cell in a checkout compiles (the port's own kernel library
# is built into build/tpubody_torch/).
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE, _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "tpubody")
EXIT_NO_CARD, EXIT_IMPORTS = 3, 4


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``tpubody_torch`` is not ``tpubody``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finite(x):
    """JSON without NaN or infinities: a non-finite number becomes null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.cell_of(harness.benchmark_spec(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return EXIT_NO_CARD
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T0, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs without JAX and "
              f"the JAX package", file=sys.stderr)
        return EXIT_IMPORTS
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
