"""Run one cell of the benchmark of ``repro_torch`` on this machine's GPUs.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs the
same set-up and window with the program's spans and the device profiler on
and prints its per-layer metrics, the device's busy and window seconds,
and a breakdown. Either way the last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``compared`` last), and the numbers compared for ``correct`` are the last
lines of standard error. Without enough CUDA devices, outside a checkout
that holds the program, or with JAX loaded, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX behind a library."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import repro_torch  # noqa: F401  (the program under test must be here)

    from bench import harness
    t_start = harness.process_start_s()
    cell = harness.find_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, compared = cell.driver().run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device="cuda", t_start=t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    harness.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
