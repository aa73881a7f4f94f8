"""Timing and profiling helpers (counterpart of ``wicca_tpu/utils/timing.py``).

``StageTimer`` collects wall time per named stage (the harness's
``run-metrics.json``); ``format_proc_time`` formats a duration; ``trace``
records a ``torch.profiler`` trace of host and CUDA work (a Chrome trace
JSON, viewed in Perfetto).

Spans and counters inside the port. Tracing is on exactly while a
``torch.profiler`` session records: any session an operator starts, or
:func:`trace`. Then each :func:`span` opens a ``wicca.<name>`` range in the
session, on the profiler's own host timeline, which it aligns with the
card's activity (a span's ``args`` show as the range's ``args`` where the
session records shapes, as :func:`trace` does), and adds its host seconds
and one call to a registry; :func:`count` adds to a counter there. :func:`snapshot` returns the
registry, :func:`reset` empties it. With no session recording a span is
one flag check and a shared no-op context, and a count does nothing. The
program writes none of this to disk.

The names, by layer:

* ``codec.encode``, ``codec.decode``: the codec's host API, whole calls;
* ``ops.<kernel>``: each kernel wrapper (checks, allocation, launch; the
  names of the wrappers' ``LAUNCHES`` counters);
* ``harness.<stage>``: the stages of the harness's ``StageTimer``
  (``decode``, the main thread's wait on the decode pool; ``icon_dwt``;
  ``resize`` and ``inference`` on the classifier threads;
  ``wait_classifiers``, the main thread's wait on them; ``results``, the
  comparison, summaries and CSVs), and the counters ``harness.batches``
  (batches collected from the classifiers) and ``harness.classify_hidden``
  (those the classifiers had finished before the main thread came to them);
* ``data.load_image`` (argument: the file name) on the decode pool, and the
  counter ``data.decoded_mp``;
* ``model.upload``, ``model.forward`` (the forward's host dispatch),
  ``model.fetch`` and the counter ``model.images``;
* ``container.entropy_encode``, ``container.assemble``,
  ``container.parse``, ``container.entropy_decode`` and the counters
  ``container.serialized_mp``, ``container.deserialized_mp`` (frame
  megapixels, H x W / 1e6);
* ``link.up``, ``link.down`` and the counters ``link.up_bytes``,
  ``link.down_bytes``: every hand-over between host memory and the
  device's tensors (on a CPU device the hand-over moves nothing, and is
  counted all the same).

A session records the ranges of the thread that started it only, unless it
is made with ``profile_all_threads`` (as :func:`trace` makes it); the
registry counts spans on every thread.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

# A range of the profiler's host timeline, opened in C++: some 2 us a range
# where ``record_function`` takes 13, and the one whose keyword values a
# session keeps (``record_function``'s string argument is dropped). Private,
# as the flag below; the tests guard both against a torch upgrade.
_RANGE = torch._C._profiler._RecordFunctionFast


def format_proc_time(seconds: float) -> str:
    """Human-readable duration, e.g. ``1 h 2 min 5 sec``."""
    seconds = int(round(seconds))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    parts = []
    if h:
        parts.append(f"{h} h")
    if m:
        parts.append(f"{m} min")
    if s or not parts:
        parts.append(f"{s} sec")
    return " ".join(parts)


# -- spans and counters ------------------------------------------------------

_LOCK = threading.Lock()
_SPANS: dict[str, list] = {}  # name -> [host seconds, calls]
_COUNTERS: dict[str, float] = {}


def recording() -> bool:
    """Whether a ``torch.profiler`` session records now. Reads the
    profiler's private module flag ``torch.autograd.profiler.
    _is_profiler_enabled``, which torch keeps for fast checks from Python
    (a test guards it against a torch upgrade)."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The shared no-op context of a span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str, args):
        self.name = name
        if args is None:  # (an explicit keyword_values=None aborts the process)
            self.range = _RANGE("wicca." + name)
        else:
            self.range = _RANGE("wicca." + name, keyword_values={"args": str(args)})

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        with _LOCK:
            s = _SPANS.get(self.name)
            if s is None:
                _SPANS[self.name] = [seconds, 1]
            else:
                s[0] += seconds
                s[1] += 1
        return False


def span(name: str, args=None):
    """A context: while a profiler session records, the range
    ``wicca.<name>`` (``args``, as a string, names the request: a file, a
    batch) and its host seconds and call in the registry; else a shared
    no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


def spanned(name: str):
    """Decorator: the whole call of the function is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, amount: float) -> None:
    """Adds ``amount`` to the counter ``name`` while a profiler session records."""
    if _autograd_profiler._is_profiler_enabled:
        with _LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + amount


def snapshot() -> dict:
    """A copy of the registry: ``{"spans": {name: (seconds, calls)},
    "counters": {name: value}}``."""
    with _LOCK:
        return {"spans": {k: (v[0], v[1]) for k, v in _SPANS.items()}, "counters": dict(_COUNTERS)}


def reset() -> None:
    """Empties the registry (between an operator's sessions, and in tests)."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


class StageTimer:
    """Accumulates wall time per named stage; totals() for structured logs.
    Each stage is also the span ``harness.<name>`` (with ``args``)."""

    def __init__(self):
        self._acc: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, args=None):
        t0 = time.perf_counter()
        try:
            with span("harness." + name, args):
                yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def totals(self) -> dict[str, float]:
        return dict(self._acc)

    def report(self) -> str:
        total = sum(self._acc.values()) or 1e-12
        lines = [
            f"{name:>20}: {t:8.3f}s ({100 * t / total:5.1f}%) x{self._count[name]}"
            for name, t in sorted(self._acc.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


def _all_threads():
    """The profiler's option to record every thread, where this torch has it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: str | Path = "wicca_trace"):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    present; every thread, where the installed torch can; with the ops'
    shapes and the spans' ``args``); writes
    ``<log_dir>/trace.json`` (Chrome trace format) at the end and yields
    the profiler. The port's spans show in it as ``wicca.*`` ranges, and
    :func:`snapshot` holds their totals."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, record_shapes=True, experimental_config=_all_threads()) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
