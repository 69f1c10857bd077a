"""One run of one cell: set-up, the measured window, the correctness
comparison, and the result. Everything a cell needs is found by name:
the cell in BENCHMARK.json's workloads, its configuration in the file
the configuration's entry names, its traffic mix in
benchmark/traffic/<traffic>.json, its reference in the modules
benchmark/reference/<name>.py the configuration names (check.py) and
each metric's reader in benchmark/metrics/<metric>.py.

A traced run (--trace 1) turns the measured package's tracer on for the
window; an untraced one leaves it off. Both read the package's counters
over the window."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

from . import check, entries, host, program, traffic
from . import window as W
from .readings import Readings

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "webp_tpu")
# The libraries of the measured package a run builds in set-up.
LIBS = ("webp_enc", "webp_dec")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Forbidden top-level names in sys.modules, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A workload of BENCHMARK.json with its configuration and mix."""

    def __init__(self, name: str):
        self.bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(os.path.join(
            ROOT, configs[self.spec["config"]]["file"]))
        self.mix = load_json(os.path.join(
            BENCH_DIR, "traffic", self.spec["traffic"] + ".json"))
        traffic.check_mix(self.mix)
        self.options = dict(self.config["options"])
        self.control = self.config.get("control", {})
        self.reference = check.reference_modules(self.config)

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports: its end-to-end metrics,
        or with trace its per-layer ones."""
        def here(m, default):
            return self.name in m["workloads"] if "workloads" in m \
                else default(m)
        e2e = [m for m in self.bench["end_to_end"] if here(m, lambda m: True)]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if here(m, lambda m: m["moves"] in names)]


def load_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_age() -> float:
    """Seconds since this process started, from /proc (0 without it)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def say(*parts) -> None:
    print("#", *parts, flush=True)


def prepare(cell: Cell, seed: int, device):
    """Builds the package's libraries and makes the pool's inputs from the
    seed: (images, inputs) with inputs the files for a decode mix."""
    import torch

    from webp_tpu_torch import _build

    on_card = device is None
    t = time.perf_counter()
    _build.build(list(LIBS) + (list(_build.KERNEL_LIBS) if on_card else []))
    say(f"build/load of the package's libraries {time.perf_counter() - t:.3f} s")
    gen_dev = torch.device("cuda" if on_card else device)
    imgs = entries.make_images(cell.mix, seed, gen_dev)
    inputs = imgs
    if cell.mix["entry"] == "decode":
        inputs = entries.make_files(cell.mix, cell.options, imgs, device)
        say(f"decode pool: {len(inputs)} files, "
            f"{sum(map(len, inputs))} bytes, sha256 {entries.pool_hash(inputs)}")
    say(f"pool: {len(imgs)} images {sorted(set(traffic.pool_sizes(cell.mix)))}"
        f", sha256 {entries.pool_hash(imgs)}")
    return imgs, inputs


def run(cell: Cell, seed: int, seconds: float, trace: bool, device=None,
        age0: float = None, t_start: float = None, workers: int = None):
    """One run. device None: the card (the measured path); "cpu" runs the
    package's plain versions (tests only: no metric of such a run is a
    device number). workers: the reference's worker processes (default
    one per core). Returns (result dict, check numbers)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    age0 = process_age() if age0 is None else age0

    def stage(what):
        say(f"set-up at {age0 + time.perf_counter() - t_start:.3f} s: {what}")

    stage("interpreter and imports")
    on_card = device is None
    f = host.facts()
    say(f"host: cpu {f['cpu']}; cores {f['cores']}")
    for g in f["gpus"]:
        say(f"card ({f['gpu_fields']}): {g}")
    say(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    chips = int(cell.spec.get("chips", 1))
    if on_card:
        dev_name = torch.cuda.get_device_name(0)
        say(f"device: {dev_name} x {torch.cuda.device_count()} "
            f"(this cell uses {chips})")
        torch.zeros(1, device="cuda")
        stage("the card's context")
    imgs, inputs = prepare(cell, seed, device)
    stage("libraries loaded, inputs made")
    call = entries.make_call(cell.mix, cell.options, inputs, device)
    t = time.perf_counter()
    n_warm = entries.warm(call, cell.mix)
    entries.synchronize(device)
    say(f"warm-up: {n_warm} requests, {time.perf_counter() - t:.3f} s; "
        f"counters {program.counters()}")
    stage("warmed up")
    program.reset_counters()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    traced_n = int(cell.mix.get("trace_requests", 1)) if trace else 0
    dtrace = None
    host_starts: list = []
    served = [0]
    if trace:
        from .trace import DeviceTrace

        dtrace = DeviceTrace()
        dtrace.start()

    def timed(items):
        k = served[0]
        served[0] += 1
        if k >= traced_n:
            return call(items)
        host_starts.append(time.perf_counter())
        with dtrace.request_range():
            out = call(items)
            entries.synchronize(device)
        return out

    keep = check.Keeper(cell.mix, seed)

    def after(req):
        if served[0] == traced_n and dtrace is not None and dtrace.on:
            dtrace.stop()
        keep(req)

    from .spans import host_tail

    span = host_tail() if trace else None
    reqs = traffic.request_items(cell.mix, seed)
    prog = None                 # the package's spans of a traced window
    if trace:
        span.__enter__()
        program.start()
    try:
        t0, requests = W.run_closed(timed, reqs, seconds, after)
        entries.synchronize(device)
    finally:
        if trace:
            prog = program.stop()
            span.__exit__(None, None, None)
        if dtrace is not None and dtrace.on:
            dtrace.stop()
    t_end = time.perf_counter()
    setup_s = age0 + (t0 - t_start)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    cnt = program.counters()
    say(f"window: {len(requests)} requests in {t_end - t0:.3f} s "
        f"(set-up {setup_s:.3f} s); counters {cnt}")

    r = Readings(cell.spec, cell.mix, cell.options, traffic.pool_sizes(
        cell.mix), t0, requests, setup_s,
        host_tail=span.intervals if span is not None else None,
        traced=requests[:traced_n], program=prog, counters=cnt)
    for line in program.summary_lines(prog, r.items()):
        say(line)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu", "count": chips if on_card else 0,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": device_info}
    if trace and served[0] > 0:
        from . import trace as TR

        r.trace = dtrace.read(host_starts)
        tr = r.trace
        say(f"trace: {len(tr.device)} device activities, "
            f"{len(tr.kernels)} kernels, {len(tr.markers)} request ranges; "
            f"clock offset (profiler minus host clock) {tr.offset} s")
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        req_spans = [(q.start, q.end) for q in r.traced]
        gaps = program.idle_gaps(tr, prog, {
            "host tail": span.intervals,
            f"{cell.mix['entry']} outside the host tail": req_spans})
        say(f"idle gaps: {len(gaps)}, {sum(g for _, g in gaps)} s; "
            f"labelled by program spans "
            f"{program.labelled_share(gaps, prog)}")
        result["breakdown"] = {"device_ops": TR.device_ops(tr),
                               "idle_gaps": gaps[:10]}
    for m in cell.metrics(trace):
        v = load_reader(m["name"])(r)
        if v is not None:
            result["metrics"][m["name"]] = {"value": float(v),
                                            "unit": m["unit"]}
        else:
            say(f"metric {m['name']}: nothing to read in this run")

    # The comparison, outside the window and after the peak was read.
    items = check.sample(cell.mix, seed, requests)
    t = time.perf_counter()
    res = check.reference(cell, imgs, inputs, items, requests,
                          workers=workers)
    nums = check.numbers(cell.mix, requests, res)
    n_cmp = check.kept(requests, res["ref"])
    n_rec = sum(c for _, c in res.get("recon", {}).values())
    say(f"reference: pool items {items} in {time.perf_counter() - t:.3f} s "
        f"on the CPU; {n_cmp} outputs compared, {n_rec} read back against "
        f"the reconstruction, {len(res.get('pool', {}))} pool files checked")
    result["attempted"] = sum(len(q.items) for q in requests)
    result["failed"] = result["attempted"] - r.items()
    for q in requests:
        if q.error:
            say(f"request failed: {q.error}")
    # A check that compared nothing, or read nothing back, is no pass.
    result["correct"] = check.correct(nums) and n_cmp > 0 and (
        cell.mix["entry"] == "decode" or n_rec > 0)
    result["checks"] = nums
    return result, nums
