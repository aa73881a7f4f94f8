"""A classifier of the benchmark's configurations (``swin-l384`` by default,
``maxvit-xl512``: the registry's ``SwinL384``, ``MaxViTXL512``) on a CUDA
card: one batch forward at a time, as ``TorchClassifier`` runs it, with the
benchmark's seeded weights (the configuration's ``reference``).

    python3 experiments/classifier_forward.py [--config swin-l384] [--batches 25 14] [--seed 7]

Prints one JSON line: the card and its power limit; per batch size the
device milliseconds of a forward (CUDA events, the forward queued behind a
spin kernel, median of 5), the host milliseconds to queue it there and on
an idle device, the peak memory, and the largest logit gap (|port -
reference| over the reference's largest |logit|, per row) of the bfloat16
port and of the float8 control against the float32 reference on seeded
inputs; the spans and counts one forward makes; and the ten device
operations that took most time in one profiled forward of the first batch
size, with their share.
"""

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from wicca_tpu_torch.models import registry  # noqa: E402
from wicca_tpu_torch.utils import timing  # noqa: E402

SPIN_CYCLES = 200_000_000


def gap(got, want) -> float:
    return float(((got.float() - want).abs().amax(dim=1) / want.abs().amax(dim=1)).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="swin-l384")
    ap.add_argument("--batches", type=int, nargs="+", default=[25, 14])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    cfg = json.loads(open(os.path.join(ROOT, "benchmark", "configs", f"{args.config}.json")).read())
    ref = importlib.import_module(os.path.splitext(cfg["reference"])[0].replace("/", "."))
    size = tuple(cfg["input_size"])
    power = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    out = {"card": torch.cuda.get_device_name(dev), "power_limit": power}
    t0 = time.perf_counter()
    module = registry.build(cfg["architecture"], size).to(dev).eval()
    weights = ref.make_weights(cfg, args.seed, dev)
    module.load_state_dict(dict(zip(module.state_dict(), weights)), strict=True)
    torch.cuda.synchronize(dev)
    out["load_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    out["batches"] = {}
    for b in args.batches:
        pixels = torch.randint(0, 256, (b, *size, 3), generator=gen, device=dev, dtype=torch.uint8)
        x = ref.preprocess(pixels.cpu()).to(dev)
        nchw = x.permute(0, 3, 1, 2)
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.inference_mode():
            for _ in range(2):  # warm
                module(nchw)
            torch.cuda.synchronize(dev)
            spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            dev_ms, host_ms = [], []
            for _ in range(5):
                spin.record()
                torch.cuda._sleep(SPIN_CYCLES)
                start.record()
                h0 = time.perf_counter()
                logits = module(nchw)
                host_ms.append(1e3 * (time.perf_counter() - h0))
                end.record()
                torch.cuda.synchronize(dev)
                dev_ms.append(start.elapsed_time(end))
            spin_ms = spin.elapsed_time(start)
            idle_host_ms = []  # the same forward queued on an idle device, no spin before it
            for _ in range(5):
                torch.cuda.synchronize(dev)
                h0 = time.perf_counter()
                module(nchw)
                idle_host_ms.append(1e3 * (time.perf_counter() - h0))
            torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        want = torch.cat([ref.forward(x[i : i + 8], weights, cfg) for i in range(0, b, 8)])
        low = torch.cat([ref.forward(x[i : i + 8], weights, cfg, fp8=True) for i in range(0, b, 8)])
        flops = ref.flops(cfg, *size) * b
        med = statistics.median(dev_ms)
        out["batches"][b] = {"device_ms": dev_ms, "host_ms": host_ms, "spin_ms": spin_ms,
                             "idle_host_ms": idle_host_ms, "memory_peak_bytes": peak,
                             "gap_bf16": gap(logits, want), "gap_fp8": gap(low, want),
                             "tflops_per_s": flops / med / 1e9, "mfu_pct": 100 * flops / (med / 1e3) / 989e12}
    from torch.profiler import ProfilerActivity, profile

    b = args.batches[0]
    x = torch.zeros(b, 3, *size, device=dev)
    timing.reset()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        module(x)
        torch.cuda.synchronize(dev)
    snap = timing.snapshot()
    out["spans_per_forward"] = {k: v[1] for k, v in snap["spans"].items()}
    out["counts_per_forward"] = snap["counters"]
    rows = []
    for e in prof.key_averages():
        self_us = getattr(e, "self_device_time_total", None)
        self_us = getattr(e, "self_cuda_time_total", 0) if self_us is None else self_us
        if self_us > 0:
            rows.append((e.key, self_us, e.count))
    total = sum(r[1] for r in rows)
    out["profiled"] = {"device_us": total, "kernels": sum(r[2] for r in rows),
                       "top": [[k[:90], round(t, 1), n, round(100 * t / total, 2)]
                               for k, t, n in sorted(rows, key=lambda r: -r[1])[:12]]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
