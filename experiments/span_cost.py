"""Host cost of the port's spans (``wicca_tpu_torch.utils.timing``), with no
profiler session recording and with one recording.

    python3 experiments/span_cost.py        # a CUDA card for the roundtrip part

Prints one JSON line: the microseconds of a ``with span(...)`` block, of a
call through ``@spanned`` and of ``count`` (each less the bare loop or
call), off and on (a CPU session); whether ``torch.autograd.profiler.
_is_profiler_enabled`` flips with a session and whether a session made
with ``profile_all_threads`` records a range opened on a pool thread. On a
card it adds the depth-5 Haar roundtrip (``encode`` -> ``decode(emit_u8)``
of a 3x8704x6144 uint8 frame): the spans one roundtrip opens, its host
milliseconds from the call to its return (median of 400, synchronized
after each) with no session and inside a CPU + CUDA session, and the
spans' off cost as a share of the untraced host time.
"""

import concurrent.futures
import json
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wicca_tpu_torch.utils import timing  # noqa: E402

N = 200_000


def _per_call_us(body, n: int = N) -> float:
    """Median over 5 rounds of ``body(n)``'s microseconds per iteration."""
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        body(n)
        rounds.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(rounds)


def _bare(n):
    for _ in range(n):
        pass


def _spans(n):
    span = timing.span
    for _ in range(n):
        with span("cost.probe"):
            pass


def _counts(n):
    count = timing.count
    for _ in range(n):
        count("cost.probe", 1)


def _plain():
    return None


@timing.spanned("cost.probe")
def _decorated():
    return None


def _calls(fn):
    def body(n):
        for _ in range(n):
            fn()
    return body


def micro(n: int) -> dict:
    bare, plain = _per_call_us(_bare, n), _per_call_us(_calls(_plain), n)
    return {"span_us": _per_call_us(_spans, n) - bare, "spanned_us": _per_call_us(_calls(_decorated), n) - plain,
            "count_us": _per_call_us(_counts, n) - bare}


def threads_recorded(all_threads: bool) -> bool:
    cfg = timing._all_threads() if all_threads else None
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as prof:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            pool.submit(_thread_range).result()
    return any(e.name == "wicca.cost.thread" for e in prof.events())


def _thread_range():
    with timing.span("cost.thread"):
        torch.ones(4).sum()


def roundtrip() -> dict:
    from wicca_tpu_torch import QuantSpec, decode, encode

    dev = torch.device("cuda", 0)
    x = torch.randint(0, 256, (3, 8704, 6144), dtype=torch.uint8, device=dev)
    spec = QuantSpec(base_step=1.0)

    def host_ms(reps):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            stream = encode(x, levels=5, spec=spec)
            decode(stream, emit_u8=True)
            out.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize(dev)
        return statistics.median(out)

    host_ms(50)
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        host_ms(1)
    spans = sum(c for _, c in timing.snapshot()["spans"].values())
    off = [host_ms(400) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = host_ms(400)
    return {"spans_per_roundtrip": spans, "host_ms_off": off, "host_ms_on": on}


def main() -> None:
    with profile(activities=[ProfilerActivity.CPU]):
        flag_on = timing.recording()
    result = {"torch": torch.__version__, "flag_flips": flag_on and not timing.recording(),
              "pool_thread_recorded": threads_recorded(False),
              "pool_thread_recorded_all_threads": threads_recorded(True), "off": micro(N)}
    with profile(activities=[ProfilerActivity.CPU]):
        result["on"] = micro(N // 20)
    if torch.cuda.is_available():
        result["device"] = torch.cuda.get_device_name(0)
        result.update(roundtrip())
        off_ms = statistics.median(result["host_ms_off"])
        result["off_share_pct"] = 100 * result["spans_per_roundtrip"] * result["off"]["spanned_us"] / 1e3 / off_ms
    print(json.dumps(result))


if __name__ == "__main__":
    main()
