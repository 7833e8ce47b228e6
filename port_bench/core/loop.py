"""The one load generator: a closed loop of one caller over a pool of inputs.

The configuration gives the matrices: ``n``, ``batch`` (matrices a call;
null: one ``(n, n)`` matrix with no batch dimension), ``dtype`` and
``generator`` (``port_bench/reference/generators/<generator>.py``, which
draws them from the seed). A traffic mix (``port_bench/traffic/<mix>.json``)
gives the calls:

- ``entry``: the call of the program, ``port_bench/entries/<entry>.py``,
  which also says whether its inputs live on the card or the host;
- ``pool``: distinct inputs, cycled call by call;
- ``sizes`` (optional): the orders the pool's inputs cycle through, input
  ``k`` of order ``sizes[k % len(sizes)]``; the configuration's ``n``
  where it is left out;
- ``sample``: answers kept for the correctness check, a uniform sample of
  the window's calls drawn from the seed;
- ``trace_calls``: calls in the traced segment of a ``--trace 1`` run.

One caller waits for each result before it sends the next call: every
user of the library blocks on its answer.
"""

from __future__ import annotations

import dataclasses
import random
import time

import numpy as np
import torch

from port_bench.reference import counts


@dataclasses.dataclass
class Window:
    calls: int
    inversions: int
    seconds: float
    latencies: list        # seconds, one a call
    oks: list              # the host's ok, one a call
    sample: list           # (call index, answer, ok tensor or None)


def sub_seed(seed: int, j: int) -> int:
    """The seed of the ``j``-th group of inputs drawn from ``seed``; the
    first group takes ``seed`` itself."""
    return seed if j == 0 else (seed * 0x9E3779B1 + j) % 2**63


class Load:
    """The pool of inputs of one cell and seed, and the calls on it."""

    def __init__(self, cell, seed: int, device):
        config, traffic = cell.config, cell.traffic
        entry, generator = cell.entry(), cell.generator()
        self.device = torch.device(device)
        self.dtype = config["dtype"]
        self.batch = config["batch"]
        self.per_call = self.batch or 1
        self.pool_size = int(traffic["pool"])
        self.seed = int(seed)
        self.host = entry.INPUTS == "host"
        if self.host and self.batch:
            raise ValueError("host inputs are one flat matrix a call")
        sizes = [int(n) for n in traffic.get("sizes") or [config["n"]]]
        self.sizes = [sizes[k % len(sizes)] for k in range(self.pool_size)]
        self.pool = [None] * self.pool_size
        for j, n in enumerate(dict.fromkeys(self.sizes)):
            ks = [k for k, m in enumerate(self.sizes) if m == n]
            s = sub_seed(self.seed, j)
            if self.host:
                drawn = generator.host(s, len(ks), n,
                                       dtype=getattr(np, self.dtype))
            else:
                drawn = generator.device(
                    s, (len(ks),) + ((self.batch,) if self.batch else ())
                    + (n, n), device=self.device,
                    dtype=getattr(torch, self.dtype))
            for k, x in zip(ks, drawn):
                self.pool[k] = x
        self._call = entry.bind(self.device)

    def input(self, k: int) -> torch.Tensor:
        """Pool input ``k`` as a card (or CPU) tensor of the answer's
        shape."""
        x = self.pool[k]
        if isinstance(x, torch.Tensor):
            return x
        n = self.sizes[k]
        return torch.from_numpy(x.reshape(n, n)).to(self.device)

    def call(self, i: int):
        """Call ``i``: ``(answer, ok tensor or None, ok on the host)``."""
        k = i % self.pool_size
        return self._call(self.pool[k], self.sizes[k])

    def work(self, calls: int) -> dict:
        """Operations and bytes (``reference/counts.py``) of calls 0 to
        ``calls - 1``, and the dtype they are counted in."""
        ns = [self.sizes[i % self.pool_size] for i in range(calls)]
        item = np.dtype(self.dtype).itemsize
        return {"flops": sum(counts.inverse_flops(n, self.per_call)
                             for n in ns),
                "bytes": sum(counts.inverse_bytes(n, self.per_call, item)
                             for n in ns),
                "dtype": self.dtype}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """One call on each pool input: the kernels load, the graph of
        each signature is captured, the allocator holds the blocks the
        calls use."""
        for i in range(self.pool_size):
            self.call(i)
        self.sync()

    def window(self, seconds: float, sample: int) -> Window:
        """Calls until ``seconds`` have passed since the first; the last
        call started before the end finishes. Keeps a uniform sample of
        ``sample`` answers (reservoir sampling, drawn from the seed)."""
        rng = random.Random(2 * self.seed + 1)
        lat, oks, kept = [], [], []
        start = time.perf_counter()
        end, i, t1 = start + seconds, 0, start
        while i == 0 or t1 < end:
            t0 = time.perf_counter()
            answer, ok_t, ok = self.call(i)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            oks.append(ok)
            if i < sample:
                kept.append((i, answer, ok_t))
            else:
                j = rng.randrange(i + 1)
                if j < sample:
                    kept[j] = (i, answer, ok_t)
            i += 1
        return Window(i, i * self.per_call, t1 - start, lat, oks, kept)
