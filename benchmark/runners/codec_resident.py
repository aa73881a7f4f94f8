"""Haar roundtrips of frames that lie on the card: ``encode`` then
``decode(emit_u8=True)`` on the cell's frames in rotation, one roundtrip in
flight, each result synchronized before the next call. Spans: ``host``
(call to return, before the synchronize) and ``sync``; samples:
``roundtrip_ms``, each roundtrip from the call to its last kernel's end by
CUDA events on the stream (which is idle at the call)."""

from __future__ import annotations

import statistics
import time

from benchmark.lib.frames import derive
from benchmark.lib.runner import Reservoir, Stopwatch, sync
from benchmark.runners._codec import CodecRunner

QUEUED = 16  # roundtrips timed behind a spin kernel for the trace check
SPIN_CYCLES = 10_000_000  # some 5 ms of spinning: ten times what the host takes to queue a roundtrip
TRACE_AGREES = (0.90, 1.05)  # traced device ms per roundtrip over the untraced reading, where the trace is sound


class Runner(CodecRunner):
    def setup(self) -> None:
        from wicca_tpu_torch import decode, encode

        self.encode, self.decode = encode, decode
        with self.phase("inputs"):
            self.frames = self.make_frames()
        self.args = self.codec_args()
        self.keep = Reservoir(int(self.cell.traffic["sample"]), derive(self.cell.seed, "sample"))
        self.watch = Stopwatch(self.device)
        with self.phase("warm"):  # every roundtrip's shapes, and as many results held as the sample holds
            held = [self._roundtrip(self.frames[i % len(self.frames)]) for i in range(self.keep.k + 2)]
            sync(self.device)
            del held
        self.last = self.queued_ms = None

    def _roundtrip(self, x):
        stream = self.encode(x, **self.args)
        return stream, self.decode(stream, emit_u8=True)

    def step(self, i: int) -> float:
        idx = i % len(self.frames)
        self.watch.start()
        with self.span("host"):
            stream, recon = self._roundtrip(self.frames[idx])
        self.watch.stop()
        with self.span("sync"):
            sync(self.device)
        self.samples["roundtrip_ms"].append(self.watch.ms())
        answer = (idx, stream.ll, stream.details, recon)
        slot = self.keep.slot()
        if slot is not None:
            self.keep.items[slot] = answer
        self.last = answer
        return self.mp[idx]

    def device_ms(self) -> tuple[float, float, float]:
        """Device milliseconds of one roundtrip, untraced: a spin kernel holds
        the stream until the host has queued the whole roundtrip, so CUDA
        events around it time the device's work without the host's gaps.
        Returns the median of ``QUEUED`` roundtrips, the shortest spin and
        the longest host time to queue one (which has to stay under it)."""
        import torch

        spin, work = Stopwatch(self.device), Stopwatch(self.device)
        times, spins, host = [], [], []
        for k in range(QUEUED):
            spin.start()
            torch.cuda._sleep(SPIN_CYCLES)
            spin.stop()
            work.start()
            t0 = time.perf_counter()
            held = self._roundtrip(self.frames[k % len(self.frames)])
            work.stop()
            host.append(1e3 * (time.perf_counter() - t0))
            sync(self.device)
            times.append(work.ms())
            spins.append(spin.ms())
            del held
        return statistics.median(times), min(spins), max(host)

    def trace_check(self, trace) -> tuple[bool, str]:
        """The traced slice's merged device time per roundtrip against
        :meth:`device_ms`: a trace that dropped operations or recorded them
        short reads low, one that stretched them reads high."""
        if self.device.type != "cuda" or not trace.steps:
            return True, ""
        if self.queued_ms is None:
            self.queued_ms, self.spin_ms, self.queue_host_ms = self.device_ms()
        traced = 1e3 * trace.busy_s / len(trace.steps)
        ratio = traced / self.queued_ms
        lo, hi = TRACE_AGREES
        note = (f"{traced:.6f} ms of device time a roundtrip in the trace, {self.queued_ms:.6f} untraced "
                f"(queued behind a {self.spin_ms:.3f} ms spin; the host queued a roundtrip in at most "
                f"{self.queue_host_ms:.3f} ms): ratio {ratio:.4f}, sound within [{lo}, {hi}]")
        if self.queue_host_ms >= self.spin_ms:
            return False, f"{note}; the spin ended before the host had queued a roundtrip: no reading"
        return lo <= ratio <= hi, note

    def check(self):
        answers = [a for a in self.keep.items if a is not None and a is not self.last] + [self.last]
        return self.judge(answers, lambda i: self.frames[i])
