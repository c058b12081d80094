"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs the cell NAME of BENCHMARK.json on the card this process sees
(benchmark/harness.py) and prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer ones with --trace 1,
each {"value", "unit"}), `device` (with --trace 1 also `busy_s` and
`window_s`), with --trace 1 `breakdown`, then `run` (what the run did)
and, last, `compared`: each number the check compared, with its limit.
The same numbers end standard error, one a line.

Exits non-zero, and prints no result, without a CUDA device, or with
fewer than the cell asks for, or if the process holds jax, jaxlib, flax
or the JAX package after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
# the checkout's root, in place of this directory, so that the benchmark's
# modules are found as `benchmark.*` and shadow nothing
sys.path[:] = [str(BENCH.parent)] + [p for p in sys.path
                                     if Path(p or ".").resolve() != BENCH]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from benchmark import harness
    spec = harness.load_spec()
    chips = harness.cell(spec, args.workload)["chips"]
    t = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{chips}", file=sys.stderr)
        return 2
    torch_s = time.perf_counter() - t
    result, compared = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    result["run"]["torch_import_s"] = torch_s
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
