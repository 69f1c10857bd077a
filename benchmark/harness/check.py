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
  pixels_differing       decode: samples of the checked items' outputs
                         that differ from the independent decoder's
                         pixels (a shape that differs counts every sample)
  pool_files_differing   decode: files of the pool, written in set-up by
                         the measured package, whose bytes differ from the
                         reference encoder's file for that image

The reference runs after the window, one item per job, in worker
processes on the CPU (one thread each), none of which imports the
measured package.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os

import numpy as np

from . import traffic


def sample(mix: dict, seed: int, requests) -> list:
    """The pool items whose outputs are checked. "check_from":
    "first_request" takes the first check_items items of the window's
    first request (with check_items the stream's batch: every slot of one
    batch); otherwise the first check_items pool items of the seed's check
    order that the window served."""
    n = int(mix.get("check_items", 1))
    if mix.get("check_from") == "first_request":
        first = next((r for r in requests if not r.error), None)
        return list(dict.fromkeys(first.items))[:n] if first else []
    served = {i for r in requests for i in r.items}
    order = [i for i in traffic.check_order(mix, seed) if i in served]
    return order[:n]


def first_outputs(requests, items) -> dict:
    """item -> the first output the window produced for it."""
    out = {}
    for r in requests:
        if r.error:
            continue
        for i, o in zip(r.items, r.outputs):
            if i in items and i not in out:
                out[i] = bytes(o) if not isinstance(o, np.ndarray) else o
    return out


# --- the jobs, run in the workers --------------------------------------------

def _init_worker():
    import torch

    torch.set_num_threads(1)


def _encode_job(entry: str, rgb, options: dict, got):
    """The reference's file for rgb, and whether `got` (the program's
    output, or None), read back by the independent decoder before its
    loop filter, differs from the reference's reconstruction: (file,
    differs, reconstruction compared)."""
    from benchmark.reference.decode import decode_unfiltered
    from benchmark.reference.encode import encode_file, stream_frame

    fn = stream_frame if entry == "encode_lossy_stream" else encode_file
    ref, recon = fn(rgb, options)
    if got is None or recon is None:
        return ref, 0, False
    try:
        back = decode_unfiltered(got)
    except Exception:  # an unreadable file differs
        return ref, 1, True
    differs = any(a.shape != b.shape or bool(np.any(a != b))
                  for a, b in zip(back, recon))
    return ref, int(differs), True


def _decode_job(data: bytes, loop_filter: bool):
    from benchmark.reference.decode import decode_rgb

    return decode_rgb(data, loop_filter=loop_filter)


def _pool_job(rgb, options: dict, data: bytes) -> int:
    from benchmark.reference.encode import encode_file

    return int(encode_file(rgb, options)[0] != bytes(data))


def _pool(n_jobs: int, workers: int = None):
    n = max(1, min(n_jobs, workers or len(os.sched_getaffinity(0))))
    return cf.ProcessPoolExecutor(
        max_workers=n, mp_context=multiprocessing.get_context("spawn"),
        initializer=_init_worker)


def reference(mix: dict, options: dict, images: list, inputs: list,
              items: list, requests, control: dict = None,
              workers: int = None) -> dict:
    """The reference's results for the checked items. control: the
    configuration's control (a guarantee broken), which the reference
    computes instead of the configuration. Returns {"ref": {item:
    output}, and for encode "recon": {item: (differs, compared)}, for
    decode "pool": {pool item: differs}}."""
    entry = mix["entry"]
    control = control or {}
    got = first_outputs(requests, set(items))
    out = {"ref": {}}
    with _pool(len(items) + (len(inputs) if entry == "decode" else 0),
               workers) as ex:
        if entry == "decode":
            loop_filter = not control.get("no_loop_filter", False)
            futs = {i: ex.submit(_decode_job, inputs[i], loop_filter)
                    for i in items}
            pool = {i: ex.submit(_pool_job, images[i], options, inputs[i])
                    for i in range(len(inputs))}
            out["ref"] = {i: f.result() for i, f in futs.items()}
            out["pool"] = {i: f.result() for i, f in pool.items()}
            return out
        opts = dict(options, **control.get("options", {}))
        futs = {i: ex.submit(_encode_job, entry, images[i], opts,
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
            if i in ref:
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
