"""Whether the timed calls' answers are right: a comparison with the plain
reference (``reference/inverse.py``, float64), run after the window has
closed and the program's state is freed.

The reference inverts every pool input again, from the inputs the harness
handed to the program. Then, for the window's answers:

- ``ok_mismatch``: calls whose ``ok`` differs from the reference's (every
  call's host ``ok``, and the sampled calls' flags matrix by matrix). An
  answer that never came (the flat API's empty vector) counts here.
  Limit 0.
- ``resid``: the largest ``||A X - I||_F / (||A||_F ||X||_F)`` over the
  sampled answers' matrices, in float64: the backward error, which holds
  whatever the conditioning of the input.
- ``resid_col``: the largest ``sqrt(n) ||A x_j - e_j||_2 / (||A||_F
  ||X||_F)`` over the sampled answers' columns ``x_j``: the worst
  column's residual, scaled so that a residual spread evenly over the
  columns reads as ``resid``. One wrong element of ``X`` puts its whole
  error into one column, where ``resid`` spreads it over all n, so this
  is the number that sees it at n = 4096.
- ``inv_err``: the largest ``||X - X_ref||_F / (||A||_F ||X_ref||_F^2)``:
  the gap from the reference's inverse over what the conditioning allows,
  since a backward error E moves the inverse by about ``X_ref E X_ref``.

A sampled answer that is missing or not finite reads ``inf``. Each cell's
limits are in ``port_bench/limits/<config>.json``, by the configuration
the cell runs, with the readings they were set from.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import inverse as reference

# Matrices the reference inverts at once.
CHUNK = 2048
NAMES = ("ok_mismatch", "resid", "resid_col", "inv_err")


def references(load) -> list:
    """``[(X_ref, ok_ref)]`` of every pool input of ``load``, float64, in
    the inputs' shape."""
    out = []
    for k in range(load.pool_size):
        a = load.input(k)
        flat = a.reshape(-1, a.shape[-2], a.shape[-1])
        xs, oks = [], []
        for start in range(0, flat.shape[0], CHUNK):
            x, ok = reference.inverse(flat[start:start + CHUNK].double())
            xs.append(x)
            oks.append(ok)
        out.append((torch.cat(xs).reshape(a.shape),
                    torch.cat(oks).reshape(a.shape[:-2])))
    return out


def gaps(a: torch.Tensor, x: torch.Tensor, xref: torch.Tensor):
    """``(resid, resid_col, inv_err)``: the largest of each over the
    matrices of ``a`` (the input), ``x`` (the answer) and ``xref``
    (float64)."""
    n = a.shape[-1]
    a64, x64 = a.double(), x.double()
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    scale = torch.linalg.matrix_norm(a64) * torch.linalg.matrix_norm(x64)
    r = a64 @ x64 - eye
    resid = torch.linalg.matrix_norm(r) / scale
    cols = torch.linalg.vector_norm(r, dim=-2).amax(dim=-1)
    resid_col = math.sqrt(n) * cols / scale
    del r
    gap = torch.linalg.matrix_norm(x64 - xref) / (
        torch.linalg.matrix_norm(a64)
        * torch.linalg.matrix_norm(xref) ** 2)
    worst = (float(resid.max()), float(resid_col.max()), float(gap.max()))
    return tuple(v if math.isfinite(v) else math.inf for v in worst)


def answer_tensor(load, answer, shape) -> torch.Tensor | None:
    """The answer as a tensor of ``shape`` on the load's device, or None
    where it never came (an empty flat vector)."""
    if isinstance(answer, np.ndarray):
        if answer.size != math.prod(shape):
            return None
        answer = torch.from_numpy(np.ascontiguousarray(answer))
    return answer.reshape(shape).to(load.device)


def readings(load, window, refs=None) -> dict:
    """The numbers compared, for the window's calls and sampled answers."""
    refs = references(load) if refs is None else refs
    pool = load.pool_size
    ref_ok = [bool(ok.all()) for _, ok in refs]
    mismatch = sum(ok != ref_ok[i % pool] for i, ok in enumerate(window.oks))
    worst = dict.fromkeys(NAMES[1:], 0.0)
    for i, answer, ok_t in window.sample:
        a = load.input(i % pool)
        xref, okref = refs[i % pool]
        x = answer_tensor(load, answer, a.shape)
        if x is None:
            worst = dict.fromkeys(worst, math.inf)
            continue
        if ok_t is not None:
            mismatch += int((ok_t.reshape(okref.shape).to(okref.device)
                             != okref).sum())
        for name, v in zip(NAMES[1:], gaps(a, x, xref)):
            worst[name] = max(worst[name], v)
    if not window.sample:
        worst = dict.fromkeys(worst, math.inf)
    return {"ok_mismatch": int(mismatch), **worst}


def verdict(values: dict, limits: dict):
    """``(correct, checks)``: every number at or under its limit, and
    ``{name: {"value", "limit"}}`` in :data:`NAMES` order."""
    checks = {}
    for name in NAMES:
        limit = limits[name]["limit"]
        checks[name] = {"value": values[name], "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
