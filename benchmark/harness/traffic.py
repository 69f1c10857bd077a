"""The one traffic generator: reads a mix's parameters (a JSON file under
benchmark/traffic/) and turns them, with the run's seed, into a pool of
distinct inputs and the order in which requests draw on it.

A mix's keys:

  entry              the measured entry point: "encode" (one image per
                     request), "encode_lossy_stream" (a list of images per
                     request) or "decode" (one file per request)
  sizes              [{"w", "h", "share"}]: the geometries; a size's share
                     of the pool and of the requests is proportional to
                     "share"
  distinct_per_size  distinct images per unit of share
  items_per_request  images (or files) a request carries
  call_options       keyword arguments of the entry beside the
                     configuration's options
  files              for "decode": how set-up writes the pool's files from
                     its images ({"entry": "encode_batch", "batch": n})
  check_items        distinct pool items the reference checks per run
  check_from         "first_request": the first check_items items of the
                     window's first request (default: drawn from the seed)
  trace_requests     requests from the window's start that a traced run
                     profiles on the device

Every loop is closed: one caller waits for each reply before the next.
Every seed gives the same sizes and the same number of requests of each
size: the requests walk the pool in cycles, each a permutation drawn from
the seed, so a seed changes the content and the order, not the work's mix.
"""

from __future__ import annotations

import random

ENTRIES = ("encode", "encode_lossy_stream", "decode")


def check_mix(mix: dict) -> None:
    if mix.get("entry") not in ENTRIES:
        raise ValueError(f"mix entry {mix.get('entry')!r} is not one of "
                         f"{ENTRIES}")
    if mix.get("check_from", "seed") not in ("seed", "first_request"):
        raise ValueError(f"mix check_from {mix['check_from']!r}")
    if mix["entry"] != "encode_lossy_stream" and \
            mix.get("items_per_request", 1) != 1:
        raise ValueError(f"{mix['entry']} takes one item per request")
    if mix["entry"] == "decode" and "files" not in mix:
        raise ValueError("a decode mix says how its files are written")
    if not mix.get("sizes"):
        raise ValueError("a mix needs sizes")


def pool_sizes(mix: dict) -> list:
    """[(w, h)] per pool item, grouped by size."""
    out = []
    for s in mix["sizes"]:
        out += [(int(s["w"]), int(s["h"]))] * (
            int(mix["distinct_per_size"]) * int(s.get("share", 1)))
    return out


def request_items(mix: dict, seed: int):
    """Endless iterator of requests, each a list of pool indices."""
    n_pool = len(pool_sizes(mix))
    per = int(mix.get("items_per_request", 1))
    rng = random.Random(seed)
    cycle: list = []
    while True:
        req = []
        while len(req) < per:
            if not cycle:
                cycle = list(range(n_pool))
                rng.shuffle(cycle)
            req.append(cycle.pop())
        yield req


def check_order(mix: dict, seed: int) -> list:
    """The pool items in the order the reference checks them, drawn from
    the seed: the sizes taken in turn, so that a sample of at least as
    many items as sizes holds every size."""
    rng = random.Random(seed ^ 0xC4EC)
    by_size: dict = {}
    for i, wh in enumerate(pool_sizes(mix)):
        by_size.setdefault(wh, []).append(i)
    groups = [rng.sample(items, len(items)) for items in by_size.values()]
    out = []
    while any(groups):
        for g in groups:
            if g:
                out.append(g.pop())
    return out
