"""Host <-> device transfer of streams and arrays for the folder pipeline
(counterpart of ``wicca_tpu/codec/transfer.py``).

Every copy goes through pinned host memory, on a CUDA stream of its own that
first waits for the work the caller's stream has queued (which produced, or
last used, the device memory involved); the caller then waits on that copy's
own CUDA event, never on ``torch.cuda.synchronize()``, so a pool thread
waiting for one frame's copy does not hold up the main thread's dispatch of
the next frame, and the copies of the folder pipeline's pool threads stay
off the stream its kernels run on. Device memory is allocated on the
caller's stream. A pinned buffer lives until its copy has finished: each
function returns only after its copy's event, holding its buffers until
then.

Every copy also feeds :func:`link_bandwidth`, the measured link rate of the
folder pipeline's cost model (its bytes over the CUDA-event time between
two events recorded around the copy on its stream).

The reference's PACK1 k-bit packing of detail codes
(``wicca_tpu/codec/transfer.py``, ``native/pack.cpp``) is not ported: it
exists for a link of tens of MB/s, and a PCIe card's pinned copies run at
GB/s (ROADMAP, Queue 1 item 6, has the measured figure). Its wire format was
never persisted, so no output depends on it; :func:`enabled` says it is off.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch

from wicca_tpu_torch._device import host_data_device
from wicca_tpu_torch.utils.ema import RateEMA

_PROBE_BYTES = 1 << 26

# measured link rate (bytes/s), an EMA over real copies; None until the
# first copy or probe ("unmeasured"). Copies under 4 MB are ignored: they
# time the call, not the link.
_link_bw = RateEMA(None, min_units=float(1 << 22))
_probe_lock = threading.Lock()


def enabled() -> bool:
    """Whether packed transfers are on: never, here (module docstring)."""
    return False


def _timed_copy(dev: torch.device, copy) -> list[torch.Tensor]:
    """Run ``copy()`` (which enqueues copies on the current stream and
    returns their results) on a stream of its own that first waits for the
    caller's stream, between two timing events; wait on the second and
    record the bytes moved into the link EMA."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs = copy()
            end.record()
    end.synchronize()
    _link_bw.record(sum(t.numel() * t.element_size() for t in outs), start.elapsed_time(end) / 1e3)
    return outs


def _to_host(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """CUDA tensors of one card -> pinned CPU tensors (one event wait)."""
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    return _timed_copy(tensors[0].device, lambda: [h.copy_(t, non_blocking=True) for h, t in zip(outs, tensors)])


def _to_device(tensors: list[torch.Tensor], dev: torch.device) -> list[torch.Tensor]:
    """CPU tensors -> tensors on ``dev`` through pinned memory (one event
    wait on a card; a plain move for the CPU)."""
    if dev.type != "cuda":
        return [t.to(dev) for t in tensors]
    pinned = [t.pin_memory() for t in tensors]  # alive until the event below has passed
    outs = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in tensors]  # on the caller's stream
    return _timed_copy(dev, lambda: [d.copy_(p, non_blocking=True) for d, p in zip(outs, pinned)])


def link_bandwidth(probe: bool = False, device=None) -> float | None:
    """Measured host-device link rate in bytes/s (an EMA over real copies).

    ``math.inf`` where the device is the CPU (a "transfer" is a memcpy);
    ``None`` while nothing was measured, unless ``probe``: that times one
    pinned 64 MB host-to-device copy and one device-to-host copy (once per
    process) to seed the estimate."""
    dev = host_data_device(device)
    if dev.type != "cuda":
        return math.inf
    if probe:
        with _probe_lock:  # the folder pipeline's pool threads route at once
            if _link_bw.rate() is None:
                h = torch.ones(_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
                d = torch.empty(_PROBE_BYTES, dtype=torch.uint8, device=dev)
                d.copy_(h)  # warm: the first copy sets up the DMA path
                _timed_copy(dev, lambda: [d.copy_(h, non_blocking=True)])
                _timed_copy(dev, lambda: [h.copy_(d, non_blocking=True)])
    return _link_bw.rate()


def _planes(stream) -> list:
    return [stream.ll] + [b for bands in stream.details for b in bands]


def _rebuild(stream, planes):
    n = len(stream.details)
    details = tuple(tuple(planes[1 + i * 3 + j] for j in range(3)) for i in range(n))
    return dataclasses.replace(stream, ll=planes[0], details=details)


def fetch_stream(stream):
    """A stream on a card -> the same stream with pinned CPU tensors, bit
    for bit (one pinned copy per plane, one wait on the copy's own event).
    A stream already on the host is returned as it is."""
    planes = _planes(stream)
    if all(p.device.type == "cpu" for p in planes):
        return stream
    return _rebuild(stream, _to_host(planes))


def put_stream(stream, device=None):
    """A host stream (CPU tensors) -> the same stream on ``device`` (CUDA
    unless the caller passes ``device='cpu'``), through pinned memory."""
    planes = _planes(stream)
    if any(p.device.type != "cpu" for p in planes):
        raise ValueError("put_stream moves a stream whose planes lie on the host")
    return _rebuild(stream, _to_device(planes, host_data_device(device)))


def put_array(x: np.ndarray, device=None) -> torch.Tensor:
    """A host array -> a tensor on ``device``, through pinned memory."""
    dev = host_data_device(device)
    return _to_device([torch.from_numpy(np.ascontiguousarray(x))], dev)[0]


def fetch_array_parallel(x) -> np.ndarray:
    """A tensor (or array) -> numpy on the host: a CUDA tensor through one
    pinned copy and a wait on its own event (a PCIe link needs none of the
    reference's chunk-parallel fetches). Keeps the reference's name."""
    if isinstance(x, torch.Tensor):
        return (x if x.device.type == "cpu" else _to_host([x])[0]).numpy()
    return np.asarray(x)
