"""Shared EMA rate tracker for the measured-rate cost models of the folder
pipeline (counterpart of ``wicca_tpu/utils/ema.py``): the host encode and
decode rates (``codec/host_encode.py``, ``codec/host_decode.py``), the
pinned host-device link and the device route's own rate
(``codec/transfer.py``, ``codec/batch.py``)."""

from __future__ import annotations

import threading


class RateEMA:
    """Exponential moving average of a measured rate (units per second).

    ``rate()`` returns ``prior`` until the first sample (or ``None`` when no
    prior is given: "unmeasured"). Samples below ``min_units`` are ignored:
    tiny work items time the call overhead, not the path. Samples may come
    from several threads at once (the folder pipeline's pool)."""

    def __init__(self, prior: float | None, alpha: float = 0.4, min_units: float = 0.0):
        self.prior = prior
        self.alpha = alpha
        self.min_units = min_units
        self._value: float | None = None
        self._lock = threading.Lock()

    def rate(self) -> float | None:
        return self._value if self._value is not None else self.prior

    def record(self, units: float, seconds: float) -> None:
        if seconds <= 0 or units < self.min_units:
            return
        r = units / seconds
        with self._lock:
            self._value = r if self._value is None else self.alpha * r + (1.0 - self.alpha) * self._value

    def reset(self) -> None:
        with self._lock:
            self._value = None
