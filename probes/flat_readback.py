"""The flat API's readback of one 4096^2 FP32 answer, old and new.

    PYTHONPATH=. python3 probes/flat_readback.py [--n 4096] [--reps 5]

Inverts the hollow matrix of seed 1 once on the card, then reads the
answer back to a flat numpy vector two ways, in the order old, new, new,
old, ``--reps`` times each turn:

- ``old``: ``inv.cpu().numpy().reshape(-1).astype(np.float32)``, the
  readback the flat API had: a pageable D2H into fresh pages, then a
  second host copy. Its two parts are timed apart (``old_d2h_ms``,
  ``old_astype_ms``).
- ``new``: ``api._readback``: one D2H into a page-locked block of torch's
  host cache, returned as a flat view.

Each rep is timed on the host clock from a synchronized card to the
vector in hand; the vector is then dropped, as a caller that is done with
it would, and the drop is timed too (``*_free_ms``). Prints one JSON line:
the card's name and power limit, each turn's ms, the medians, the GB/s
the medians give for the answer's bytes, whether every vector's bits
equal the first old one's, and ``api.stats()`` over the new turns. Needs
a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from gpu_matrix_inversion_tpu_torch import api
from gpu_matrix_inversion_tpu_torch.models import solver
from gpu_matrix_inversion_tpu_torch.utils.generators import (
    hollow_random_matrix)


def _old(inv):
    """The flat API's former readback, its two copies timed apart."""
    t0 = time.perf_counter()
    host = inv.cpu()
    t1 = time.perf_counter()
    out = host.numpy().reshape(-1).astype(np.float32)
    t2 = time.perf_counter()
    return out, {"old_d2h_ms": 1e3 * (t1 - t0),
                 "old_astype_ms": 1e3 * (t2 - t1)}


def _new(inv):
    return api._readback(inv, np.float32), {}


def _turn(name, fn, inv, reps, want, rows):
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, parts = fn(inv)
        t1 = time.perf_counter()
        same = out.tobytes() == want
        t2 = time.perf_counter()
        del out
        t3 = time.perf_counter()
        rows.append(dict(parts, turn=name, ms=1e3 * (t1 - t0),
                         free_ms=1e3 * (t3 - t2), same=same))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    n = args.n
    a = torch.from_numpy(hollow_random_matrix(n, seed=1)).to("cuda")
    inv, ok = solver.inverse(a)
    if not bool(ok):
        raise SystemExit("the probe's input came back singular")
    want = inv.cpu().numpy().reshape(-1).tobytes()
    rows = []
    api.clear_stats()
    for name, fn in (("old", _old), ("new", _new), ("new", _new),
                     ("old", _old)):
        _turn(name, fn, inv, args.reps, want, rows)
    nbytes = inv.numel() * inv.element_size()
    out = {"card": card, "n": n, "bytes": nbytes, "reps": args.reps,
           "rows": rows, "stats": api.stats(),
           "bits_match": all(r["same"] for r in rows)}
    for name in ("old", "new"):
        mine = [r for r in rows if r["turn"] == name]
        med = statistics.median(r["ms"] for r in mine)
        out[f"{name}_ms"] = med
        out[f"{name}_gb_s"] = nbytes / med / 1e6
        out[f"{name}_free_ms"] = statistics.median(r["free_ms"] for r in mine)
    for part in ("old_d2h_ms", "old_astype_ms"):
        out[part] = statistics.median(r[part] for r in rows if part in r)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
