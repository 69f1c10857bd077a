"""What the two forms of ops/planar.first_min cost in encode() at methods
5 and 6: one torch.min reduction against a chain of strict-less selects
(planar.min_chain). Both give the same winner, so the files must be equal.

    python3 tools/first_min_cost.py                     # the card, 1536x1024
    python3 tools/first_min_cost.py --device cpu --w 64 --h 48 --load 5

Runs encode(img, method=M) for M = 5 and 6 with first_min set to each form
in turn (planar.first_min and trellis.first_min, alternated over --reps
rounds after one warm-up call each) and prints each call's wall seconds
and the median per form. On the card encode() ends with the file on the
host, so its wall time holds the whole device program; phase 2 there is
replayed from a CUDA graph, one kernel per PyTorch operation. --load N
(CPU) starts N busy processes beside the runs, as a test run's other
workers would be; they are stopped at the end.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import webp_tpu_torch  # noqa: E402
from webp_tpu_torch.ops import planar as PL  # noqa: E402
from webp_tpu_torch.ops import trellis as TR  # noqa: E402

FIRST_MIN = PL.first_min
FORMS = {"torch.min": lambda x: torch.min(x, dim=0), "chain": PL.min_chain}


def image(h, w, seed):
    """Smooth gradients with a noisy patch and stripes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                    ((x + 2 * y) * 3) % 256], -1).astype(np.int32)
    img[: h // 2, w // 2:] += rng.integers(-60, 60, (h // 2, w - w // 2, 3))
    img[:, 5::11] = 255
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--w", type=int, default=1536)
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--load", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    if a.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA card")
    img = image(a.h, a.w, a.seed)
    sync = torch.cuda.synchronize if a.device == "cuda" else (lambda: None)
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(a.load)]
    try:
        for method in (5, 6):
            times, files = {k: [] for k in FORMS}, {}
            for rep in range(a.reps + 1):
                for name, form in FORMS.items():
                    PL.first_min = TR.first_min = form
                    sync()
                    t = time.perf_counter()
                    data = webp_tpu_torch.encode(img, device=a.device,
                                                 method=method)
                    sync()
                    dt = time.perf_counter() - t
                    files.setdefault(name, data)
                    if rep:  # the first round warms up
                        times[name].append(dt)
            if len(set(files.values())) != 1:
                raise AssertionError(f"method {method}: the forms' files "
                                     "differ")
            print(f"method {method}, {a.w}x{a.h} on {a.device}, load "
                  f"{a.load}: " + "; ".join(
                      f"{k} median {statistics.median(v):.3f} s "
                      f"({', '.join(f'{t:.3f}' for t in v)})"
                      for k, v in times.items()), flush=True)
    finally:
        PL.first_min = TR.first_min = FIRST_MIN
        for p in busy:
            p.kill()
            p.wait()


if __name__ == "__main__":
    main()
