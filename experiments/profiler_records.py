"""How many of a timed call's launches ``torch.profiler`` records, for the
PACK1 kernels P1-P3 and for K1, in a process of their own.

    python3 experiments/profiler_records.py        # needs a CUDA card and nvcc

On the depth-5 Haar ``QuantSpec(1.0)`` stream of the photograph-like
3x8704x6144 frame that ``chip_smoke.py`` makes from seed 0 (P1 and P2 on
its detail planes, P3 on the host's upload buffer of them, K1 on the
frame), each kernel's wrapper is called 20 times inside one profiler
session, in six ways: CUDA activity alone (twice), CPU and CUDA, with
0.1 s of host sleep at both ends of the session, with a synchronize after
each call, and CPU and CUDA with the sleeps. Each line gives the launches
recorded of the 20 and their median device time (us). ``chip_smoke.py``
times the same kernels late in a long process, where the profiler
records fewer of them.
"""

import collections
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 20


def session(fn, activities, pad: float, sync_each: bool):
    """The CUDA events of one profiler session of ``REPS`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(pad)
        for _ in range(REPS):
            fn()
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        time.sleep(pad)
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_records: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity

    import chip_smoke as cs
    from wicca_tpu_torch import QuantSpec, encode
    from wicca_tpu_torch.codec import transfer
    from wicca_tpu_torch.ops import dwt_cuda
    from wicca_tpu_torch.ops import pack_cuda as pk

    dev = torch.device("cuda")
    frame = torch.from_numpy(cs.photo_like((3, cs.H, cs.W), 0)).to(dev)
    st = encode(frame, levels=cs.LEVELS, spec=QuantSpec(1.0))
    details = transfer._stream_planes(st)
    meta = transfer._plane_meta([(tuple(p.shape), p.dtype) for p in details])
    kcs = transfer._choose_kcs_sticky(pk.pack1_stats(details).cpu().numpy(), meta)
    umeta, parts = transfer._pack_host(transfer.fetch_stream(st, force=False))
    hbuf, layout = transfer._upload_buffer(umeta, parts, pinned=True)
    dbuf = hbuf.to(dev)
    calls = {
        "pack1_stats_kernel": lambda: pk.pack1_stats(details),
        "pack1_pack_kernel": lambda: pk.pack1_pack(details, kcs, st.ll),
        "pack1_unpack_kernel": lambda: pk.pack1_unpack(dbuf, layout),
        "icon_": lambda: dwt_cuda.icon(frame, 5),
    }
    cuda, both = [ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ways = (("cuda", cuda, 0.0, False), ("cuda again", cuda, 0.0, False), ("cpu+cuda", both, 0.0, False),
            ("cuda, 0.1 s pads", cuda, 0.1, False), ("cuda, sync each", cuda, 0.0, True),
            ("cpu+cuda, 0.1 s pads", both, 0.1, False))
    for match, fn in calls.items():
        for way, activities, pad, sync_each in ways:
            events = session(fn, activities, pad, sync_each)
            hit = [e.device_time for e in events if match in e.name]
            names = collections.Counter(e.name[:60] for e in events)
            median = statistics.median(hit) if hit else None
            print(f"{match:22s} {way:22s} recorded {len(hit):3d} of {REPS}; median {median} us; all {dict(names)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
