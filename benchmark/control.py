"""The control of a cell's correctness comparison, at the cell's own
sizes: for each seed, the cell's inputs, and for a sample of them the
program's output, the reference's, and the control's (the reference with
the one guarantee the configuration's "control" entry breaks), compared
by the cell's own numbers. The control has to come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 \
        [--items 2]

Prints one JSON line per seed: {"seed", "program": numbers, "control":
numbers}, each number [value, limit]. Needs the card, as a run does.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import check, entries, runner, traffic  # noqa: E402
from benchmark.harness.window import Request  # noqa: E402


def control_numbers(cell, seed: int, n_items: int, device=None) -> dict:
    imgs, inputs = runner.prepare(cell, seed, device)
    call = entries.make_call(cell.mix, cell.options, inputs, device)
    items = traffic.check_order(cell.mix, seed)[:n_items]
    per = int(cell.mix.get("items_per_request", 1))
    program = []
    for k in range(0, len(items), per):
        chunk = items[k:k + per]
        program.append(Request(chunk, 0.0, outputs=call(chunk)))
    ref = check.reference(cell, imgs, inputs, items, program)
    ctl = check.reference(cell, imgs, inputs, items, program,
                          control=cell.control)
    as_program = [Request([i], 0.0, outputs=[ctl["ref"][i]]) for i in items]
    # An encode control's files are read back against the reference's
    # reconstruction, as the program's are.
    ref_ctl = ref if cell.mix["entry"] == "decode" else check.reference(
        cell, imgs, inputs, items, as_program)
    return {"seed": seed, "items": items,
            "breaks": cell.control.get("breaks", ""),
            "program": check.numbers(cell.mix, program, ref),
            "control": check.numbers(cell.mix, as_program, ref_ctl)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--items", type=int, default=None)
    a = ap.parse_args(argv)
    cell = runner.Cell(a.workload)
    n = a.items or int(cell.mix.get("check_items", 1))
    for seed in a.seeds:
        print(json.dumps(control_numbers(cell, seed, n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
