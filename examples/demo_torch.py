"""End-to-end demo on the PyTorch/CUDA port (``wicca_tpu_torch``), the twin
of ``examples/demo.py``.

Generates a small synthetic dataset, then walks the whole package: icons,
the lossless and quantized codecs, ``.wct`` files, the classifier-comparison
harness, analysis tables and plots (saved as PNGs; only where matplotlib
and seaborn are installed, else the demo says so and ends there).
Everything runs on the card unless ``--device cpu`` is given; without a card
and without it the first call raises.

Run:  python examples/demo_torch.py [output_dir] [--device cpu]
"""

import argparse
import importlib.util
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo checkout use

import numpy as np


def make_dataset(folder: Path, n: int = 8) -> None:
    import cv2

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:768, 0:1024].astype(np.float32)
    for i in range(n):
        img = np.clip(
            128
            + 70 * np.sin(xx / (13 + 5 * i))
            + 55 * np.cos(yy / (17 + 3 * i))
            + rng.normal(0, 10, yy.shape),
            0,
            255,
        ).astype(np.uint8)
        rgb = np.stack([img, np.roll(img, 11, 0), np.roll(img, 23, 1)], -1)
        cv2.imwrite(str(folder / f"img_{i:02d}.png"), rgb)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="End-to-end demo of wicca_tpu_torch.")
    ap.add_argument("out", nargs="?", default="demo_out", help="output directory (default: demo_out)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    import torch

    from wicca_tpu_torch._device import host_data_device

    dev = host_data_device(args.device)
    out = Path(args.out)
    data = out / "images"
    make_dataset(data)
    print(f"dataset: {data} ({len(list(data.iterdir()))} images) on {dev}")

    # --- transforms -------------------------------------------------------
    from wicca_tpu_torch import dwt2_lifting, haar_icon, idwt2_lifting, psnr
    from wicca_tpu_torch.data.loader import load_image, to_planar

    img = load_image(data / "img_00.png")
    x = torch.from_numpy(to_planar(img)).to(dev)
    icon = haar_icon(x, 5)
    print(f"icon depth-5: {tuple(x.shape)} -> {tuple(icon.shape)}")

    ipyr = dwt2_lifting(x, 5, "haar_int")
    assert torch.equal(idwt2_lifting(ipyr), x.to(torch.int32))
    print("integer-lifting roundtrip: bit-exact")

    # --- codec ------------------------------------------------------------
    from wicca_tpu_torch.codec import decode, encode, entropy_ratio, load, save
    from wicca_tpu_torch.core.quant import QuantSpec

    stream = encode(x, levels=5, spec=QuantSpec(base_step=2.0))
    nbytes = save(stream, str(out / "img_00.wct"))
    rec = decode(load(str(out / "img_00.wct"), device=dev))
    print(
        f"codec: {x.numel()} B -> {nbytes} B ({x.numel() / nbytes:.2f}x, "
        f"entropy bound {entropy_ratio(stream):.2f}x), PSNR "
        f"{float(psnr(rec, x.float())):.2f} dB"
    )

    # lossless: LeGall 5/3 (JPEG2000 reversible) + reversible color transform
    ll_stream = encode(x, levels=5, wavelet="legall5.3", color="rct")
    ll_bytes = save(ll_stream, str(out / "img_00_lossless.wct"))
    ll_rec = decode(load(str(out / "img_00_lossless.wct"), device=dev), emit_u8=True)
    assert torch.equal(ll_rec, x)
    print(f"lossless 5/3+RCT: {x.numel()} B -> {ll_bytes} B ({x.numel() / ll_bytes:.2f}x), bit-exact")

    # --- harness ----------------------------------------------------------
    from wicca_tpu_torch.analysis import compare_summaries, extract_from_comparison
    from wicca_tpu_torch.config.constants import SIM_CLASSES_PERC
    from wicca_tpu_torch.harness import ClassifierProcessor
    from wicca_tpu_torch.models import load_models

    classifiers = load_models({"SimpleCNN": ("SimpleCNN", {"shape": (96, 96)})}, device=dev)
    proc = ClassifierProcessor(
        data,
        transform_depth=(2, 3, 4),
        interpolation=3,
        top_classes=5,
        results_folder=out / "results",
        log_info=True,
        batch_size=8,
        device=dev,
    )
    proc.process_classifiers(classifiers)
    comp = compare_summaries(out / "results", list(classifiers), (2, 3, 4))
    print(comp.to_string(index=False))

    # --- plots ------------------------------------------------------------
    missing = [m for m in ("matplotlib", "seaborn") if importlib.util.find_spec(m) is None]
    if missing:
        print(f"plots skipped: {', '.join(missing)} not installed")
        return 0
    import matplotlib

    matplotlib.use("Agg")
    from wicca_tpu_torch.viz import (
        plot_metric_radar,
        show_icon_on_image,
        show_image_vs_icon,
        visualize_comparison,
    )

    show_image_vs_icon(img, (2, 4, 6), device=dev).savefig(out / "image_vs_icon.png", dpi=80)
    show_icon_on_image(img, 4, device=dev).savefig(out / "icon_on_image.png", dpi=80)
    visualize_comparison(comp, SIM_CLASSES_PERC).savefig(out / "heatmap.png", dpi=80)
    names, vals = extract_from_comparison(comp, SIM_CLASSES_PERC)
    fig = plot_metric_radar([f"{n} d{d}" for n, d in zip(names, comp["Depth"])], vals)
    if hasattr(fig, "savefig"):
        fig.savefig(out / "radar.png", dpi=80)
    print(f"plots written to {out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
