"""The port's command line (``python -m wicca_tpu_torch --device cpu``)
against the JAX package's (``wicca_tpu.cli.main``), in-process, on the cases
of ``tests/test_cli.py``.

Each command runs once per package, writing into a directory of its own;
tolerance 0: the same exit code, the same ``.wct``, PNG and CSV bytes, and
the same stdout and stderr once the output directory's path and the
timings (the folder commands' ``seconds`` and ``mp_per_s``, the progress
bar with its times and rate) are masked. The exception is the float
lifting path (``bior4.4``), which holds the JAX package within the tolerance of
``tests/test_torch_dwt97.py``, not bit for bit (ROADMAP Queue 3): its
stream's LL and codes and its pixels are held to that tolerance, its
printed lines with their numbers masked, its PSNR within 0.05 dB.
``analyze`` reads SimpleCNN's weights from ``WICCA_TPU_WEIGHTS``: the JAX
registry's own init, as a ``.msgpack`` for the JAX package and carried into
a ``.pt`` state dict for the port.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.cli import main as jax_main
from wicca_tpu_torch.cli import build_parser
from wicca_tpu_torch.cli import main as port_main

ROOT = Path(__file__).resolve().parent.parent
_TIMING = re.compile(r'"(seconds|mp_per_s)": [0-9.e+-]+')
_PROGRESS = re.compile(r"%\|[^|\n\r]*\|[^\r\n]*")  # tqdm's bar (its width follows the rate's), times, rate


def masked(text: str, out: str) -> str:
    return _PROGRESS.sub("%|T", _TIMING.sub(r'"\1": T', text.replace(out, "{out}")))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("cli")
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    for i in range(3):  # tests/test_cli.py's images
        img = np.clip(128 + 60 * np.sin(xx / (11 + i)) + rng.normal(0, 6, (96, 128)), 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / "imgs" / f"im{i}.png"), np.stack([img] * 3, -1))
    x = np.random.default_rng(5).integers(0, 65536, (64, 96, 3), dtype=np.uint16)
    cv2.imwrite(str(root / "hi.png"), cv2.cvtColor(x, cv2.COLOR_RGB2BGR))
    for side in ("jax", "port"):
        (root / side).mkdir()
    return root


def run(capsys, workdir, side, *argv):
    """(rc, stdout, stderr) of ``argv`` ('{out}' for the side's directory,
    '{in}' for the shared inputs) through one package, masked."""
    main = jax_main if side == "jax" else lambda a: port_main(["--device", "cpu", *a])
    out = str(workdir / side)
    rc = main([a.replace("{out}", out).replace("{in}", str(workdir)) for a in argv])
    cap = capsys.readouterr()
    return rc, masked(cap.out, out), masked(cap.err, out)


def both(capsys, workdir, *argv):
    """The port's (rc, stdout, stderr) of ``argv``, after asserting that the
    JAX package's are the same."""
    want = run(capsys, workdir, "jax", *argv)
    got = run(capsys, workdir, "port", *argv)
    assert got == want
    return got


def same_files(workdir, *names):
    for name in names:
        a = (workdir / "jax" / name).read_bytes()
        assert (workdir / "port" / name).read_bytes() == a, name


def test_encode_decode_icon(workdir, capsys):
    both(capsys, workdir, "encode", "{in}/imgs/im0.png", "{out}/im0.wct", "--levels", "3")
    rc, out, _ = both(capsys, workdir, "decode", "{out}/im0.wct", "{out}/rec0.png", "--original", "{in}/imgs/im0.png")
    assert rc == 0 and "PSNR" in out
    both(capsys, workdir, "icon", "{in}/imgs/im0.png", "{out}/icon.png", "--depth", "2")
    same_files(workdir, "im0.wct", "rec0.png", "icon.png")


def test_transcode(workdir, capsys):
    both(capsys, workdir, "encode", "{in}/imgs/im2.png", "{out}/im2_layered.wct", "--levels", "3",
         "--quality-layers", "3")
    rc, out, _ = both(capsys, workdir, "transcode", "{out}/im2_layered.wct", "{out}/im2_l1.wct", "--max-layers", "1",
                      "--drop-levels", "1", "--codec", "rice")
    assert rc == 0 and "->" in out
    both(capsys, workdir, "decode", "{out}/im2_l1.wct", "{out}/im2_half.png")
    rc, _, err = both(capsys, workdir, "transcode", "{out}/im2_layered.wct", "{out}/im2_l1.wct", "--drop-levels", "9")
    assert rc == 2 and err.startswith("error:")
    same_files(workdir, "im2_layered.wct", "im2_l1.wct", "im2_half.png")


def test_icon_from_a_stream_and_a_lifting_wavelet(workdir, capsys):
    both(capsys, workdir, "encode", "{in}/imgs/im1.png", "{out}/im1_icon_src.wct", "--levels", "3")
    rc, out, _ = both(capsys, workdir, "icon", "{out}/im1_icon_src.wct", "{out}/icon_ll.png")
    assert rc == 0 and "stream LL" in out
    both(capsys, workdir, "icon", "{in}/imgs/im2.png", "{out}/icon_b.png", "--depth", "2", "--wavelet", "bior4.4")
    same_files(workdir, "im1_icon_src.wct", "icon_ll.png", "icon_b.png")


@pytest.fixture(scope="module")
def weights(workdir):
    """SimpleCNN at 64x64, the JAX registry's init, for both registries."""
    import torch
    from flax import serialization

    from wicca_tpu.config.constants import MODEL
    from wicca_tpu.models.registry import load_single_model
    from wicca_tpu_torch.models.interop import from_flax_variables

    params = load_single_model("SimpleCNN", shape=(64, 64))[MODEL].params
    root = workdir / "weights"
    root.mkdir()
    (root / "SimpleCNN.msgpack").write_bytes(serialization.to_bytes(params))
    torch.save(from_flax_variables("SimpleCNN", params, (64, 64)), root / "SimpleCNN.pt")
    return root


@pytest.mark.parametrize("extra", [[], ["--compare", "reconstruction", "--step", "2.0"]],
                         ids=["icon", "reconstruction"])
def test_analyze_and_compare(workdir, weights, capsys, monkeypatch, extra):
    monkeypatch.setenv("WICCA_TPU_WEIGHTS", str(weights))
    tag = "rec" if extra else "icon"
    assert both(capsys, workdir, "analyze", "{in}/imgs", "--models", "SimpleCNN", "--depths", "1", "2",
                "--input-size", "64", "--results-folder", f"{{out}}/res_{tag}", "--quiet", *extra)[0] == 0
    for depth in (1, 2):
        same_files(workdir, *(f"res_{tag}/depth-{depth}/{f}" for f in
                              (f"SimpleCNN-depth-{depth}.csv", f"SimpleCNN-summary-depth-{depth}.csv")))
    rc, out, _ = both(capsys, workdir, "compare", f"{{out}}/res_{tag}", "--models", "SimpleCNN", "--depths", "1", "2")
    assert rc == 0 and "similar classes" in out
    both(capsys, workdir, "compare", f"{{out}}/res_{tag}", "--models", "SimpleCNN", "--depths", "1",
         "--output", f"{{out}}/cmp_{tag}.csv")
    same_files(workdir, f"cmp_{tag}.csv")
    assert both(capsys, workdir, "compare", f"{{out}}/res_{tag}", "--models", "NopeNet", "--depths", "1")[0] == 1


def test_bad_inputs(workdir, capsys):
    assert both(capsys, workdir, "encode", "{in}/nope.png", "{out}/x.wct")[0] == 2
    assert both(capsys, workdir, "analyze", "{in}/imgs", "--models", "NopeNet", "--results-folder", "{out}/res2",
                "--quiet")[0] == 2
    assert both(capsys, workdir, "encode", "{in}/imgs/im2.png", "{out}/x.wct", "--meta", "novalue")[0] == 2
    assert both(capsys, workdir, "encode", "{in}/imgs/im2.png", "{out}/x.wct", "--target-bpp", "1.0",
                "--target-psnr", "40.0")[0] == 2


def test_encode_decode_wide_wavelet(workdir, capsys):
    import cv2
    import torch

    from tests.test_torch_dwt97 import assert_close
    from wicca_tpu_torch.codec import load

    outs = {}
    for side in ("jax", "port"):
        enc = run(capsys, workdir, side, "encode", "{in}/imgs/im1.png", "{out}/im1b.wct", "--levels", "3",
                  "--wavelet", "bior4.4", "--step", "1.0")
        dec = run(capsys, workdir, side, "decode", "{out}/im1b.wct", "{out}/rec1b.png", "--original",
                  "{in}/imgs/im1.png")
        outs[side] = (enc, dec)
    (jenc, jdec), (penc, pdec) = outs["jax"], outs["port"]
    digits = re.compile(r"[0-9.]+")
    assert [(rc, digits.sub("N", o), e) for rc, o, e in (penc, pdec)] == [
        (rc, digits.sub("N", o), e) for rc, o, e in (jenc, jdec)]
    psnr = [float(o.rsplit("PSNR", 1)[1].split("dB")[0]) for _, o, _ in (jdec, pdec)]
    assert psnr[0] > 30.0 and abs(psnr[1] - psnr[0]) <= 0.05
    streams = [load(workdir / side / "im1b.wct", device="cpu") for side in ("jax", "port")]
    assert streams[1].orig_shape == streams[0].orig_shape and streams[1].wavelet == streams[0].wavelet == "bior4.4"
    assert_close(streams[1].ll, streams[0].ll.numpy(), "LL")
    assert_close([b for d in streams[1].details for b in d], [b.numpy() for d in streams[0].details for b in d],
                 "codes")
    pixels = [cv2.imread(str(workdir / side / "rec1b.png")) for side in ("jax", "port")]
    assert_close(torch.from_numpy(pixels[1]), pixels[0], "pixels")


def test_encode_lossless_rct_and_u16(workdir, capsys):
    both(capsys, workdir, "encode", "{in}/imgs/im0.png", "{out}/im0_rct.wct", "--levels", "3", "--wavelet",
         "legall5.3", "--color", "rct", "--ll-codec", "rice")
    both(capsys, workdir, "decode", "{out}/im0_rct.wct", "{out}/im0_rct.png", "--original", "{in}/imgs/im0.png")
    both(capsys, workdir, "encode", "{in}/hi.png", "{out}/hi.wct", "--levels", "3", "--wavelet", "legall5.3")
    rc, out, _ = both(capsys, workdir, "decode", "{out}/hi.wct", "{out}/hi_rec.png", "--original", "{in}/hi.png")
    assert "PSNR inf" in out
    same_files(workdir, "im0_rct.wct", "im0_rct.png", "hi.wct", "hi_rec.png")


def test_encode_rate_control(workdir, capsys):
    rc, out, _ = both(capsys, workdir, "encode", "{in}/imgs/im2.png", "{out}/im2rc.wct", "--levels", "3",
                      "--target-bpp", "1.5", "--codec", "rc", "--rate-control", "step")
    assert rc == 0 and "rate control" in out
    rc, out, _ = both(capsys, workdir, "encode", "{in}/imgs/im2.png", "{out}/im2pcrd.wct", "--levels", "3",
                      "--target-bpp", "1.0")
    assert rc == 0 and "pcrd" in out
    both(capsys, workdir, "encode", "{in}/imgs/im1.png", "{out}/im1psnr.wct", "--levels", "3", "--target-psnr", "35")
    both(capsys, workdir, "decode", "{out}/im2rc.wct", "{out}/rec2rc.png", "--original", "{in}/imgs/im2.png")
    same_files(workdir, "im2rc.wct", "im2pcrd.wct", "im1psnr.wct", "rec2rc.png")


def test_layers_region_and_at_level(workdir, capsys):
    both(capsys, workdir, "encode", "{in}/imgs/im1.png", "{out}/im1q.wct", "--levels", "3", "--quality-layers", "3",
         "--hh-gain", "1.5")
    both(capsys, workdir, "decode", "{out}/im1q.wct", "{out}/rec1q.png", "--max-layers", "2", "--original",
         "{in}/imgs/im1.png")
    both(capsys, workdir, "decode", "{out}/im1q.wct", "{out}/roi1q.png", "--region", "8", "40", "16", "48")
    both(capsys, workdir, "decode", "{out}/im1q.wct", "{out}/half1q.png", "--at-level", "1")
    assert both(capsys, workdir, "decode", "{out}/im1q.wct", "{out}/x.png", "--at-level", "1", "--region", "0", "8",
                "0", "8")[0] == 2
    same_files(workdir, "im1q.wct", "rec1q.png", "roi1q.png", "half1q.png")


def test_roi_metadata_and_info(workdir, capsys):
    rc, out, _ = both(capsys, workdir, "encode", "{in}/imgs/im1.png", "{out}/roi.wct", "--levels", "3", "--roi",
                      "16", "48", "16", "64", "--roi-bg-shift", "2", "--meta", "camera=x1", "--meta", "site=a=b")
    assert rc == 0 and "ROI" in out and "metadata" in out
    both(capsys, workdir, "decode", "{out}/roi.wct", "{out}/roi_rec.png")
    rc, out, _ = both(capsys, workdir, "info", "{out}/roi.wct", "--planes")
    assert rc == 0 and "integrity: ok" in out
    both(capsys, workdir, "info", "{out}/roi.wct", "--json", "--no-verify")
    blob = bytearray((workdir / "port" / "roi.wct").read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    for side in ("jax", "port"):
        (workdir / side / "bad.wct").write_bytes(bytes(blob))
    assert both(capsys, workdir, "info", "{out}/bad.wct", "{out}/roi.wct")[0] == 1
    same_files(workdir, "roi.wct", "roi_rec.png")


@pytest.mark.parametrize("path", ["host", "device"])
def test_encode_and_decode_batch(workdir, capsys, path):
    rc, out, _ = both(capsys, workdir, "encode-batch", "{in}/imgs", f"{{out}}/wct_{path}", "--levels", "3",
                      "--path", path, "--meta", "batch=1")
    assert rc == 0 and json.loads(out.replace(": T", ": 0"))["images"] == 3
    rc, out, _ = both(capsys, workdir, "decode-batch", f"{{out}}/wct_{path}", f"{{out}}/png_{path}", "--path", path,
                      "--at-level", "1")
    assert rc == 0
    same_files(workdir, *(f"wct_{path}/im{i}.wct" for i in range(3)), *(f"png_{path}/im{i}.png" for i in range(3)))


def test_parser_is_the_jax_package_s_plus_device():
    """Every subcommand, flag, default and choice of ``wicca_tpu.cli``; the
    port adds the top-level ``--device`` (default ``cuda``)."""
    from wicca_tpu.cli import build_parser as jax_parser

    def spec(parser):
        subs = next(a for a in parser._actions if a.dest == "cmd").choices
        return {name: sorted((a.dest, tuple(a.option_strings), a.default, tuple(a.choices or ()), a.nargs,
                              a.required) for a in sp._actions) for name, sp in subs.items()}

    assert spec(build_parser()) == spec(jax_parser())
    top = {a.dest: a.default for a in build_parser()._actions}
    assert top["device"] == "cuda" and build_parser().prog == "wicca_tpu_torch"


def test_module_entry_point_runs():
    out = subprocess.run([sys.executable, "-m", "wicca_tpu_torch", "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert "usage: wicca_tpu_torch" in out.stdout and "encode-batch" in out.stdout
