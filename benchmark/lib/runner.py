"""What every runner shares: host spans, counters, a seeded sample of the
window's answers, and the numbers ``correct`` compares."""

from __future__ import annotations

import contextlib
import random
import time
from collections import defaultdict
from dataclasses import dataclass

import torch


@dataclass
class Check:
    """One compared number beside its limit; it holds when ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Stopwatch:
    """Milliseconds from :meth:`start` to :meth:`stop` by the device's clock:
    CUDA events on the current stream (on the CPU, for the tests, the
    host's clock). Read :meth:`ms` once the device has been synchronized."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.t = [0.0, 0.0]

    def start(self) -> None:
        if self.cuda:
            self.marks[0].record()
        else:
            self.t[0] = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.marks[1].record()
        else:
            self.t[1] = time.perf_counter()

    def ms(self) -> float:
        return self.marks[0].elapsed_time(self.marks[1]) if self.cuda else 1e3 * (self.t[1] - self.t[0])


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from a seed
    (reservoir sampling): :meth:`slot` says where answer ``n`` goes, or None."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def slot(self) -> int | None:
        n, self.seen = self.seen, self.seen + 1
        if n < self.k:
            self.items.append(None)
            return n
        j = self.rng.randrange(n + 1)
        return j if j < self.k else None


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``got`` that differ from ``want`` (all of them where the
    shapes differ)."""
    if tuple(got.shape) != tuple(want.shape):
        return max(got.numel(), want.numel())
    return int((got.to(want.device).double() != want.double()).sum())


class Runner:
    """A runner: ``setup`` makes the inputs from the cell's seed and warms
    every shape, ``step(i)`` does one unit of the window's work and returns
    its units (megapixels), ``collect`` reads what the program wrote once the
    window has closed, ``check`` compares the window's answers with the
    plain reference and ``control`` reads the same numbers with the
    reference in a lower precision put in the program's place."""

    def __init__(self, cell):
        self.cell = cell
        self.device = torch.device(cell.device)
        self.spans = defaultdict(lambda: [0.0, 0])
        self.counters = defaultdict(float)
        self.samples = defaultdict(list)  # name -> one reading per step (the window's tails)
        self.tracing = False  # set by the harness while the profiler records
        self.setup_parts: dict[str, float] = {}  # seconds of each part of set-up, for the record

    @contextlib.contextmanager
    def span(self, name: str):
        """Host seconds of the block under ``name`` (and, while tracing, a
        ``bench.<name>`` range in the trace)."""
        rf = torch.profiler.record_function(f"bench.{name}") if self.tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        s = self.spans[name]
        s[0] += time.perf_counter() - t0
        s[1] += 1

    @contextlib.contextmanager
    def phase(self, name: str):
        """Seconds of one part of set-up, kept in ``setup_parts``."""
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.setup_parts[name] = time.perf_counter() - t0

    def limit(self, name: str) -> float:
        return float(self.cell.config["limits"][name])

    def build(self) -> None:
        """Builds (once per checkout) and loads the port's kernel library on a
        card: set-up's first part, kept apart from the rest."""
        from wicca_tpu_torch.ops import _build

        if self.device.type == "cuda":
            _build.library()

    def setup(self) -> None:
        raise NotImplementedError

    def step(self, i: int) -> float:
        raise NotImplementedError

    def collect(self) -> None:
        pass

    def trace_check(self, trace) -> tuple[bool, str]:
        """Whether the traced slice's device times are to be trusted, and a
        note of what was compared. A runner that has an untraced reading of
        its steps' device time holds the trace against it here."""
        return True, ""

    def check(self) -> tuple[list[Check], int]:
        raise NotImplementedError

    def control(self) -> list[Check]:
        raise NotImplementedError
