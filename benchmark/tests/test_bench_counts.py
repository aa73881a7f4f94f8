"""The yardstick's counters from shapes."""

import json
from pathlib import Path

from benchmark.lib import counts, peaks

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_mobilenetv2_flops_at_224():
    cfg = json.loads((CONFIGS / "mobilenetv2.json").read_text())
    # 300.8 M multiply-adds (Keras reports 300 M for alpha 1.0 at 224)
    assert counts.mobilenetv2_flops(cfg, 224, 224) == 601_548_544


def test_haar_roundtrip_bytes_of_the_bench_frame():
    # 2 x 160.4 MB of frame and reconstruction + 2 x (160.3 MB of int8 codes
    # + 0.63 MB of float32 LL); chip_smoke.py's per-pass sum, 682.8 MB, also
    # moves the float32 level-3 LL between the fused passes (4 x 10.0 MB)
    assert counts.haar_roundtrip_bytes(3, 8704, 6144, 5) == 642_668_544
    ll3 = 3 * (8704 >> 3) * (6144 >> 3) * 4
    assert counts.haar_roundtrip_bytes(3, 8704, 6144, 5) + 4 * ll3 == 682_776_576


def test_icon_bytes_round_up():
    assert counts.icon_bytes(3, 2048, 2731, 2) == 3 * 2048 * 2731 + 3 * 512 * 683


def test_peaks_by_card_name():
    assert peaks.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peaks.bf16_flops_per_s("NVIDIA H100 80GB HBM3") == 989e12
    assert peaks.hbm_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
