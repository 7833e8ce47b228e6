"""Faults planted under the timed path, for the tests and the readings
that show a broken path comes out not correct.

Each takes the place of ``models.solver.inverse``, which the entries call
(the flat API through it), and breaks what it returns:

- ``unchanged``: the call returns its state unchanged (the input itself,
  ``ok`` true);
- ``half_left_out``: half of the batch left out, ``ok`` taken over the
  rest (a call with a batch only);
- ``altered``: the answer altered where it is produced: the largest
  element of each inverse negated.

No cell spans chips, so none can leave out an exchange between them.
"""

from __future__ import annotations

import contextlib
import functools

import torch

FAULTS = ("unchanged", "half_left_out", "altered")


def unchanged(sound, a, **kw):
    return a.clone(), torch.ones(a.shape[:-2], dtype=torch.bool,
                                 device=a.device)


def half_left_out(sound, a, **kw):
    half = a.shape[0] // 2
    inv, ok = sound(a[:half], **kw)
    out = torch.zeros_like(a)
    out[:half] = inv
    return out, ok.all().expand(a.shape[0]).clone()


def altered(sound, a, **kw):
    inv, ok = sound(a, **kw)
    flat = inv.reshape(-1, inv.shape[-1] ** 2).clone()
    largest = flat.abs().argmax(dim=1)
    rows = torch.arange(flat.shape[0], device=flat.device)
    flat[rows, largest] *= -1.0
    return flat.reshape(inv.shape), ok


def applies(name: str, batch) -> bool:
    """Whether fault ``name`` can happen to a call of ``batch`` matrices
    (None: one matrix)."""
    return name != "half_left_out" or bool(batch)


@contextlib.contextmanager
def planted(name: str):
    """``models.solver.inverse`` broken by fault ``name`` inside the
    block, sound again after it."""
    from gpu_matrix_inversion_tpu_torch.models import solver
    sound = solver.inverse
    solver.inverse = functools.partial(globals()[name], sound)
    try:
        yield
    finally:
        solver.inverse = sound
