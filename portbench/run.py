"""Run one cell of the benchmark and print its result as the last line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the checkout's root, on a machine with as many CUDA cards as the
cell asks for; without them it exits with code 2 and prints no result.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones from a torch.profiler window over a steady stretch of
passes. Both compare the timed film with the plain reference and print
each compared number beside its limit, last on standard error and last
in the result line (``checks``).
"""

from __future__ import annotations

import time

T0 = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    harness.cache_env(cell.root)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {found}; no result", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}; no "
              f"result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
