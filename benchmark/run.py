"""Runs one cell of the benchmark once and prints its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is BENCHMARK.json's workload of
that name; its configuration, traffic mix and metric readers are found
by name under benchmark/. Set-up builds the measured package's libraries
(into its own _build/ directory in the checkout), makes the inputs on
the card from the seed and warms every geometry the window uses; the
window then measures for --seconds; the outputs of a sample of the
inputs are compared with the plain reference after it. Earlier lines
(starting with "#") give the host, the card and the package's counters;
the numbers compared, each with its limit, are the last lines of
standard error; the last line of standard output is the result as one
JSON object. --trace 1 profiles the first requests of the window and
reports the per-layer metrics instead of the end-to-end ones.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and
3 if the process loaded JAX or the JAX package; neither prints a result.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Kernel caches stay in the checkout, at fixed paths. The measured package
# builds its own libraries into webp_tpu_torch/_build/; these are for
# anything PyTorch itself would compile.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "_cache", _sub)

from benchmark.harness import runner  # noqa: E402

_AGE0 = runner.process_age()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = runner.Cell(a.workload)

    import torch

    chips = int(cell.spec.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{a.workload} needs {chips} CUDA card(s); this machine has "
              f"{n}: no result", file=sys.stderr)
        return 2
    result, nums = runner.run(cell, a.seed, a.seconds, bool(a.trace),
                              age0=_AGE0, t_start=_T_START)
    bad = runner.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: no result", file=sys.stderr)
        return 3
    for name, (value, limit) in nums.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
