"""Whether what the timed path produced is correct: every output the
window produced for a sample of the pool's items against the plain
reference's output for that item, and every file read back by the
independent decoder.

Every comparison is exact, so every limit is 0:

  outputs_missing        items of the window's requests that got no
                         output (the request failed, or returned fewer)
  files_differing        encode: outputs of the checked items whose
                         bytes differ from the reference encoder's file
  files_unlike_recon     encode: checked items whose output, read back
                         by the independent decoder (before its loop
                         filter), differs from the reconstruction the
                         reference encoder's closed loop predicted from,
                         or cannot be read back
  pixels_differing       decode: samples of the checked items' kept
                         outputs that differ from the independent
                         decoder's pixels (a shape that differs counts
                         every sample)
  pool_files_differing   decode: files of the pool, written in set-up by
                         the measured package, whose bytes differ from the
                         reference encoder's file for that image

The reference runs after the window, one item per job, in worker
processes on the CPU (one thread each), none of which imports the
measured package.

The window keeps only the outputs the check reads (Keeper): every
output of the mix's first trace_requests requests, and of each item
that can be checked its first output and those of one request in
KEEP_EVERY after it, drawn from the seed. It drops the rest as each
request completes, so that its memory does not grow with its length (a
decode's output holds 6.3 MB). The numbers above compare every output
kept.

A configuration names its reference: "reference": {"encoder": <name>,
"decoder": <name>}, each a module benchmark/reference/<name>.py; a half
it leaves out, or the whole key, takes REFERENCE's "encode" or "decode".
The jobs take the names and import the modules in the workers. The
contract:

  encoder  encode_file(rgb, options) -> (file, reconstruction or None):
           the file encode(rgb, **options) must write;
           stream_frame(rgb, options) -> (frame, reconstruction or None):
           the VP8 frame encode_lossy_stream must return for rgb.
           The reconstruction is the (Y, U, V) uint8 planes on the
           macroblock grid the encoder's closed loop predicted from. It
           is None only for an item whose closed loop gave none (the
           default encoder: its escape list overflowed, and the host
           encoder wrote the file); that item's file is compared but not
           read back. An encode run in which no checked item is read back
           is not correct (runner.run), so an encoder that never gives a
           reconstruction cannot check a configuration.
  decoder  decode_rgb(data, loop_filter) -> RGB uint8 [h, w, 3];
           decode_unfiltered(data) -> (Y, U, V) uint8 on the macroblock
           grid before the loop filter, of a file or a bare VP8 frame.

A cell imports the modules its configuration names when it loads, and
refuses one that lacks a function of its role. A module raises where
the options ask for what it does not follow, so a configuration it
cannot check never passes as checked.
"""

from __future__ import annotations

import concurrent.futures as cf
import importlib
import multiprocessing
import os
import random

import numpy as np

from . import traffic

# The reference of a configuration without a "reference" key.
REFERENCE = {"encoder": "encode", "decoder": "decode"}
# The functions a module of each role gives.
ROLES = {"encoder": ("encode_file", "stream_frame"),
         "decoder": ("decode_rgb", "decode_unfiltered")}
# Of a checked item's outputs after its first, the window keeps those of
# one request in KEEP_EVERY, drawn from the seed.
KEEP_EVERY = 16
REFERENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference")


def reference_modules(config: dict) -> dict:
    """{"encoder": name, "decoder": name} of the configuration's reference.
    Raises ValueError where a role is unknown, a name is not a module
    benchmark/reference/<name>.py, or the module lacks a function of its
    role (ROLES)."""
    given = config.get("reference", {})
    unknown = sorted(set(given) - set(REFERENCE))
    if unknown:
        raise ValueError(f"a reference has an encoder and a decoder, "
                         f"not {unknown}")
    names = dict(REFERENCE, **given)
    for role, name in names.items():
        if not (isinstance(name, str) and name.isidentifier()
                and os.path.isfile(os.path.join(REFERENCE_DIR,
                                                name + ".py"))):
            raise ValueError(f"the reference {role} {name!r} is no module "
                             f"benchmark/reference/<name>.py")
        mod = _module(name)
        lacks = [f for f in ROLES[role] if not callable(getattr(mod, f,
                                                                None))]
        if lacks:
            raise ValueError(f"the reference {role} {name!r} has no "
                             f"{', '.join(lacks)}")
    return names


def _module(name: str):
    return importlib.import_module("benchmark.reference." + name)


def sample(mix: dict, seed: int, requests) -> list:
    """The pool items whose outputs are checked. "check_from":
    "first_request" takes the first check_items items of the window's
    first request that did not fail (with check_items the stream's batch:
    every slot of one batch); otherwise the first check_items pool items
    of the seed's check order, those the window served."""
    n = int(mix.get("check_items", 1))
    if mix.get("check_from") == "first_request":
        first = next((r for r in requests if not r.error), None)
        return list(dict.fromkeys(first.items))[:n] if first else []
    served = {i for r in requests for i in r.items}
    return [i for i in traffic.check_order(mix, seed)[:n] if i in served]


# What a dropped output leaves in its place: the count of outputs stays.
DROPPED = object()


class Keeper:
    """keeper(request), as each request of the window completes, puts
    DROPPED in place of each output that the check will not read: all but
    the outputs of the first trace_requests requests (the traced readers
    read them) and, of each item sample() can return, the first output
    and those of the requests drawn from the seed."""

    def __init__(self, mix: dict, seed: int):
        self.n = int(mix.get("check_items", 1))
        self.items = None if mix.get("check_from") == "first_request" \
            else set(traffic.check_order(mix, seed)[:self.n])
        self.whole = int(mix.get("trace_requests", 1))
        self.rng = random.Random(seed ^ 0x4B33)
        self.seen: set = set()
        self.k = 0

    def __call__(self, req) -> None:
        k, self.k = self.k, self.k + 1
        drawn = self.rng.random() * KEEP_EVERY < 1.0
        if req.error:
            return
        if self.items is None:
            self.items = set(list(dict.fromkeys(req.items))[:self.n])
        if k < self.whole:
            self.seen.update(req.items)
            return
        out = []
        for j, o in enumerate(req.outputs):
            i = req.items[j] if j < len(req.items) else None
            keep = i in self.items and (drawn or i not in self.seen)
            out.append(o if keep else DROPPED)
            self.seen.add(i)
        req.outputs = out


def kept(requests, items) -> int:
    """The outputs the window kept for the items."""
    return sum(1 for r in requests if not r.error
               for i, o in zip(r.items, r.outputs)
               if i in items and o is not DROPPED)


def first_outputs(requests, items) -> dict:
    """item -> the first output the window kept for it."""
    out = {}
    for r in requests:
        if r.error:
            continue
        for i, o in zip(r.items, r.outputs):
            if i in items and i not in out and o is not DROPPED:
                out[i] = bytes(o) if not isinstance(o, np.ndarray) else o
    return out


# --- the jobs, run in the workers --------------------------------------------

def _init_worker():
    import torch

    torch.set_num_threads(1)


def _encode_job(modules: dict, entry: str, rgb, options: dict, got):
    """The reference encoder's file for rgb, and whether `got` (the
    program's output, or None), read back by the reference decoder before
    its loop filter, differs from the encoder's reconstruction: (file,
    differs, reconstruction compared)."""
    enc = _module(modules["encoder"])
    fn = enc.stream_frame if entry == "encode_lossy_stream" \
        else enc.encode_file
    ref, recon = fn(rgb, options)
    if got is None or recon is None:
        return ref, 0, False
    try:
        back = _module(modules["decoder"]).decode_unfiltered(got)
    except Exception:  # an unreadable file differs
        return ref, 1, True
    differs = any(a.shape != b.shape or bool(np.any(a != b))
                  for a, b in zip(back, recon))
    return ref, int(differs), True


def _decode_job(decoder: str, data: bytes, loop_filter: bool):
    return _module(decoder).decode_rgb(data, loop_filter)


def _pool_job(encoder: str, rgb, options: dict, data: bytes) -> int:
    return int(_module(encoder).encode_file(rgb, options)[0] != bytes(data))


def _pool(n_jobs: int, workers: int = None):
    n = max(1, min(n_jobs, workers or len(os.sched_getaffinity(0))))
    return cf.ProcessPoolExecutor(
        max_workers=n, mp_context=multiprocessing.get_context("spawn"),
        initializer=_init_worker)


def reference(cell, images: list, inputs: list, items: list, requests,
              control: dict = None, workers: int = None) -> dict:
    """The results of the cell's reference (cell.reference, by the
    configuration) for the checked items, at the cell's mix and options.
    control: the configuration's control (a guarantee broken), which the
    reference computes instead of the configuration. Returns {"ref":
    {item: output}, and for encode "recon": {item: (differs, compared)},
    for decode "pool": {pool item: differs}}."""
    mix, options, modules = cell.mix, cell.options, cell.reference
    entry = mix["entry"]
    control = control or {}
    got = first_outputs(requests, set(items))
    out = {"ref": {}}
    with _pool(len(items) + (len(inputs) if entry == "decode" else 0),
               workers) as ex:
        if entry == "decode":
            loop_filter = not control.get("no_loop_filter", False)
            futs = {i: ex.submit(_decode_job, modules["decoder"],
                                 inputs[i], loop_filter) for i in items}
            pool = {i: ex.submit(_pool_job, modules["encoder"], images[i],
                                 options, inputs[i])
                    for i in range(len(inputs))}
            out["ref"] = {i: f.result() for i, f in futs.items()}
            out["pool"] = {i: f.result() for i, f in pool.items()}
            return out
        opts = dict(options, **control.get("options", {}))
        futs = {i: ex.submit(_encode_job, modules, entry, images[i], opts,
                             got.get(i)) for i in items}
        res = {i: f.result() for i, f in futs.items()}
    out["ref"] = {i: r[0] for i, r in res.items()}
    out["recon"] = {i: r[1:] for i, r in res.items()}
    return out


def numbers(mix: dict, requests, results: dict) -> dict:
    """name -> [value, limit] of every number compared."""
    ref = results["ref"]
    missing = 0
    differing = 0
    for r in requests:
        outs = list(r.outputs) if not r.error else []
        missing += max(0, len(r.items) - len(outs))
        for i, o in zip(r.items, outs):
            if i in ref and o is not DROPPED:
                differing += _differs(mix["entry"], o, ref[i])
    nums = {"outputs_missing": [missing, 0]}
    if mix["entry"] == "decode":
        nums["pixels_differing"] = [differing, 0]
        nums["pool_files_differing"] = [sum(results["pool"].values()), 0]
    else:
        nums["files_differing"] = [differing, 0]
        nums["files_unlike_recon"] = [
            sum(d for d, _ in results["recon"].values()), 0]
    return nums


def _differs(entry: str, got, want) -> int:
    if entry != "decode":
        return int(bytes(got) != bytes(want))
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return int(max(got.size, want.size))
    return int(np.count_nonzero(got != want))


def correct(nums: dict) -> bool:
    return all(v <= lim for v, lim in nums.values())
