"""The port stands alone: it imports neither jax nor the JAX package, obeys
the device rule, and its CPU runs never touch a kernel."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import wicca_tpu_torch
from wicca_tpu_torch import HaarCoder, QuantSpec, decode, decode_at_level, encode, ops
from wicca_tpu_torch._device import resolve_device
from wicca_tpu_torch.codec import container
from wicca_tpu_torch.codec.interop import stream_from_arrays
from wicca_tpu_torch.native import idwt, pngw, rice
from wicca_tpu_torch.ops import dwt53_cuda, dwt97_cuda, dwt_cuda

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import wicca_tpu_torch
names = [m.name for m in pkgutil.walk_packages(wicca_tpu_torch.__path__, "wicca_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "wicca_tpu")
             or m.startswith(("jax.", "jaxlib", "flax.", "optax.", "wicca_tpu.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_no_jax_and_no_wicca_tpu_in_a_fresh_process():
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for name in ("wicca_tpu_torch.ops.dwt_cuda", "wicca_tpu_torch.ops._build", "wicca_tpu_torch.codec.interop",
                 "wicca_tpu_torch.coder", "wicca_tpu_torch.core.haar", "wicca_tpu_torch.ops.dwt53_cuda",
                 "wicca_tpu_torch.core.lifting", "wicca_tpu_torch.core.color", "wicca_tpu_torch.ops.dwt97_cuda",
                 "wicca_tpu_torch.codec.container", "wicca_tpu_torch.codec.roi", "wicca_tpu_torch.codec.rd",
                 "wicca_tpu_torch.codec.transcode", "wicca_tpu_torch.native.rice", "wicca_tpu_torch.codec.batch",
                 "wicca_tpu_torch.codec.host_encode", "wicca_tpu_torch.codec.host_decode",
                 "wicca_tpu_torch.codec.transfer", "wicca_tpu_torch.native.idwt", "wicca_tpu_torch.native.pngw",
                 "wicca_tpu_torch.data.pngw", "wicca_tpu_torch.data.loader", "wicca_tpu_torch.utils.ema",
                 "wicca_tpu_torch.config.constants", "wicca_tpu_torch.config.aliases",
                 "wicca_tpu_torch.data.normalization", "wicca_tpu_torch.utils.timing", "wicca_tpu_torch.utils.env",
                 "wicca_tpu_torch.core.icon_host", "wicca_tpu_torch.models.imagenet", "wicca_tpu_torch.models.nets",
                 "wicca_tpu_torch.models.interop", "wicca_tpu_torch.models.convert", "wicca_tpu_torch.models.registry",
                 "wicca_tpu_torch.analysis.results", "wicca_tpu_torch.harness.processor"):
        assert name in res["modules"]


def test_entropy_library_builds_from_the_port_alone(tmp_path, monkeypatch):
    """g++ builds the port's own entropy.cpp into a native-<hash> directory
    under the build root it is given (wicca_tpu_torch/_build by default);
    no make, nothing of wicca_tpu/native."""
    calls = []
    run = subprocess.run
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(list(cmd)) or run(cmd, **kw))
    so = rice.build(root=tmp_path)
    assert so.exists() and so.parent.parent == tmp_path and so.parent.name.startswith("native-")
    assert len(calls) == 1 and calls[0][0] == rice.CXX
    assert not any("make" in arg or "wicca_tpu/native" in arg for arg in calls[0])
    assert [a for a in calls[0] if a.endswith(".cpp")] == [str(ROOT / "wicca_tpu_torch" / "native" / "entropy.cpp")]
    assert rice.build(root=tmp_path) == so and len(calls) == 1  # built once, then reused
    assert {p.parent for p in tmp_path.rglob("*") if p.is_file()} == {so.parent}
    assert rice.build().parent.parent == ROOT / "wicca_tpu_torch" / "_build"


@pytest.mark.parametrize("lib,flags,libs", [(idwt, ["-ffp-contract=off", "-pthread"], []),
                                             (pngw, ["-pthread"], ["-lz"])])
def test_host_libraries_build_from_the_port_alone(lib, flags, libs, tmp_path, monkeypatch):
    """g++ builds the port's own idwt.cpp (every float operation rounded on
    its own) and pngw.cpp (a shared object of its own, the only one linked
    with zlib) under the build root it is given; a failed build raises with
    its command."""
    calls = []
    run = subprocess.run
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(list(cmd)) or run(cmd, **kw))
    so = lib.build(root=tmp_path)
    assert so.exists() and so.parent.parent == tmp_path and lib.build(root=tmp_path) == so and len(calls) == 1
    cmd = calls[0]
    assert cmd[0] == "g++" and all(f in cmd for f in flags) and [a for a in cmd if a.startswith("-l")] == libs
    assert "-march=native" not in cmd and not any("make" in a or "wicca_tpu/native" in a for a in cmd)
    assert [a for a in cmd if a.endswith(".cpp")] == [str(lib.SOURCE)]
    assert lib.SOURCE.parent == ROOT / "wicca_tpu_torch" / "native"
    assert "-lz" not in rice.build_command(rice.CXX, so) and "-lz" not in idwt.build_command(idwt.CXX, so)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        lib.build(cxx="no-such-compiler", root=tmp_path)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "wicca_tpu_torch").rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_jax_import_lines(path):
    for line in (ROOT / path).read_text().splitlines():
        s = line.strip()
        assert not s.startswith(("import jax", "from jax", "import flax", "from flax", "import optax",
                                 "from optax")), line
        assert not (s.startswith(("from wicca_tpu.", "from wicca_tpu ", "import wicca_tpu"))
                    and not s.startswith(("from wicca_tpu_torch", "import wicca_tpu_torch"))), line


def test_numpy_input_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((3, 16, 16), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode(img, levels=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HaarCoder().get_small_copy(np.zeros((16, 16, 3), np.uint8), 2)
    with pytest.raises(RuntimeError):
        stream_from_arrays(np.zeros((1, 4, 4), np.float32), [])
    with pytest.raises(RuntimeError):
        resolve_device(img, "cuda")
    assert resolve_device(img, "cpu") == torch.device("cpu")


def test_folder_runs_need_a_card_or_device_cpu(tmp_path, monkeypatch):
    """A folder of numpy frames runs on the card unless device='cpu': with
    no card the folder calls raise, also when every frame would take the
    host route."""
    import cv2

    from wicca_tpu_torch.codec import batch as tbatch
    from wicca_tpu_torch.codec import transfer

    (tmp_path / "src").mkdir()
    cv2.imwrite(str(tmp_path / "src" / "a.png"), np.zeros((16, 24, 3), np.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path in ("auto", "host"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbatch.encode_folder(tmp_path / "src", tmp_path / "wct", path=path)
    tbatch.encode_folder(tmp_path / "src", tmp_path / "wct", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.decode_folder(tmp_path / "wct", tmp_path / "png")
    with pytest.raises(RuntimeError):
        transfer.link_bandwidth(probe=True)
    assert transfer.link_bandwidth(probe=True, device="cpu") == math.inf and not transfer.enabled()


def test_tensor_runs_where_it_lies():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    assert resolve_device(x) == torch.device("cpu")
    assert resolve_device(x, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(x, "cuda")


def test_cpu_runs_leave_launch_counters_at_zero():
    dwt_cuda.reset_launches()
    dwt53_cuda.reset_launches()
    dwt97_cuda.reset_launches()
    img = np.random.default_rng(0).integers(0, 256, (3, 40, 56), dtype=np.uint8)
    stream = encode(img, levels=5, spec=QuantSpec(0.75), device="cpu")
    decode(stream, emit_u8=True)
    decode(stream)
    HaarCoder().get_small_copy(np.moveaxis(img, 0, -1), 7, device="cpu")
    lossless = encode(img, levels=4, wavelet="legall5.3", color="rct", device="cpu")
    decode(lossless, emit_u8=True)
    decode_at_level(lossless, 2)
    ops.idwt_level_dequant(*ops.dwt_level_quant(torch.from_numpy(img).float()))
    lossy = encode(img, levels=4, wavelet="bior4.4", color="ict", chroma_gain=2.0, device="cpu")
    decode(lossy, emit_u8=True)
    decode_at_level(lossy, 2)
    decode(encode(img, levels=2, wavelet="db2", device="cpu"), emit_u8=True)
    assert set(dwt_cuda.LAUNCHES) == {"icon", "dwt_multilevel_quant", "idwt_multilevel_dequant", "dwt_level_quant",
                                      "idwt_level_dequant"}
    assert set(dwt53_cuda.LAUNCHES) == {"dwt53_multilevel", "idwt53_multilevel"}
    assert set(dwt97_cuda.LAUNCHES) == {"dwt97_multilevel_quant", "idwt97_multilevel_dequant"}
    assert not any(dwt_cuda.LAUNCHES.values()) and not any(dwt53_cuda.LAUNCHES.values())
    assert not any(dwt97_cuda.LAUNCHES.values())


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    ll = torch.zeros((1, 4, 4))
    codes = [(torch.zeros((1, 8, 8), dtype=torch.int8),) * 3]
    with pytest.raises(ValueError):
        dwt_cuda.idwt_multilevel_dequant(ll.double(), codes, (1.0,))
    with pytest.raises(ValueError):
        dwt_cuda.idwt_multilevel_dequant(ll, [(torch.zeros((1, 8, 8), dtype=torch.int32),) * 3], (1.0,))
    with pytest.raises(ValueError):
        dwt_cuda.idwt_multilevel_dequant(ll, codes, (1.0, 1.0))
    with pytest.raises(ValueError):
        dwt_cuda.dwt_multilevel_quant(torch.zeros((1, 12, 12), dtype=torch.uint8), (1.0, 1.0, 1.0))
    with pytest.raises(ValueError):
        dwt_cuda.dwt_multilevel_quant(torch.zeros((1, 8, 8), dtype=torch.int32), (1.0,))
    x = torch.zeros((1, 12, 12), dtype=torch.uint8)
    for k, filt in ((3, "legall5.3"), (4, "legall5.3"), (1, "cdf97")):
        with pytest.raises(ValueError):
            dwt53_cuda.dwt53_multilevel(x, k, filt)
    ll, dets = dwt53_cuda.dwt53_multilevel(x, 1)
    with pytest.raises(ValueError):
        dwt53_cuda.idwt53_multilevel(ll, dets, 1, orig_k=0)
    with pytest.raises(ValueError):
        dwt53_cuda.idwt53_multilevel(ll, dets, 2)
    with pytest.raises(ValueError):
        dwt53_cuda.idwt53_multilevel(ll, [(dets[0][0], dets[0][1], dets[0][2][..., :3])], 1)
    with pytest.raises(ValueError):
        dwt53_cuda.idwt53_multilevel(ll, [tuple(b.to(torch.int32) for b in dets[0])], 1)
    for color in ("rct", "ict"):  # rct needs 3 or 4 planes; ict is not reversible
        with pytest.raises(ValueError):
            dwt53_cuda.dwt53_multilevel(torch.zeros((2, 8, 8), dtype=torch.uint8), 1, color=color)
        with pytest.raises(ValueError):
            dwt53_cuda.idwt53_multilevel(ll, dets, 1, color=color)
    assert wicca_tpu_torch.__all__


@pytest.mark.cuda
def test_kernels_equal_plain_twins_on_the_card():
    """On a card: each kernel equals its plain twin on the same CUDA tensors
    (``python3 chip_smoke.py`` runs the full set of shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (3, 64, 96), dtype=np.uint8)).cuda()
    for depth in (1, 3, 5):
        assert torch.equal(dwt_cuda.icon(x, depth), dwt_cuda.icon_plain(x, depth))
    steps = ((0.75, 0.75, 1.125), (0.75, 0.75, 1.125), (0.75, 0.75, 1.125))
    ll, dets = dwt_cuda.dwt_multilevel_quant(x, steps)
    pll, pdets = dwt_cuda.dwt_multilevel_quant_plain(x, steps)
    assert torch.equal(ll, pll) and all(torch.equal(a, b) for da, db in zip(dets, pdets) for a, b in zip(da, db))
    for emit_u8 in (False, True):
        got = dwt_cuda.idwt_multilevel_dequant(ll, dets, steps, emit_u8, 0.3)
        assert torch.equal(got, dwt_cuda.idwt_multilevel_dequant_plain(ll, dets, steps, emit_u8, 0.3))
    xf = x.float()
    for step, quantize in ((0.75, True), (1.0, False)):
        bands = dwt_cuda.dwt_level_quant(xf, step, quantize)
        assert all(torch.equal(a, b) for a, b in zip(bands, dwt_cuda.dwt_level_quant_plain(xf, step, quantize)))
        got = dwt_cuda.idwt_level_dequant(*bands, step, quantize)
        assert torch.equal(got, dwt_cuda.idwt_level_dequant_plain(*bands, step, quantize))
    for filt in ("legall5.3", "haar_int"):
        ll, dets = dwt53_cuda.dwt53_multilevel(x, 3, filt)
        pll, pdets = dwt53_cuda.dwt53_multilevel_plain(x, 3, filt)
        assert torch.equal(ll, pll) and all(torch.equal(a, b) for da, db in zip(dets, pdets) for a, b in zip(da, db))
        got = dwt53_cuda.idwt53_multilevel(ll, dets, 3, emit_u8=True, filt=filt)
        assert torch.equal(got, dwt53_cuda.idwt53_multilevel_plain(ll, dets, 3, emit_u8=True, filt=filt))
        assert torch.equal(got, x)
        ll, dets = dwt53_cuda.dwt53_multilevel(x, 3, filt, "rct")  # the RCT folded into K6/K7
        pll, pdets = dwt53_cuda.dwt53_multilevel_plain(x, 3, filt, "rct")
        assert torch.equal(ll, pll) and all(torch.equal(a, b) for da, db in zip(dets, pdets) for a, b in zip(da, db))
        assert torch.equal(dwt53_cuda.idwt53_multilevel(ll, dets, 3, emit_u8=True, filt=filt, color="rct"), x)
    for filt in ("cdf97", "db2"):
        ll, dets = dwt97_cuda.dwt97_multilevel_quant(x, steps, filt)
        pll, pdets = dwt97_cuda.dwt97_multilevel_quant_plain(x, steps, filt)
        assert torch.equal(ll, pll) and all(torch.equal(a, b) for da, db in zip(dets, pdets) for a, b in zip(da, db))
        for emit_u8 in (False, True):
            got = dwt97_cuda.idwt97_multilevel_dequant(ll, dets, steps, emit_u8, filt=filt, recon_offset=0.3)
            assert torch.equal(got, dwt97_cuda.idwt97_multilevel_dequant_plain(ll, dets, steps, emit_u8, filt=filt,
                                                                                recon_offset=0.3))


@pytest.mark.cuda
def test_container_roundtrip_on_the_card():
    """On a card: a stream on the card serializes to the bytes of the same
    stream on the CPU and loads back onto the card, equal plane by plane
    (``python3 chip_smoke.py`` phase 3e runs the full-size frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 96, 128), dtype=np.uint8))
    for kw in (dict(), dict(wavelet="legall5.3", color="rct"), dict(wavelet="bior4.4", color="ict", chroma_gain=2.0)):
        on_card = encode(x.cuda(), levels=3, **kw)
        blob = container.serialize(on_card, quality_layers=2)
        back = container.deserialize(blob)
        assert back.ll.device.type == "cuda" and torch.equal(back.ll, on_card.ll)
        assert all(torch.equal(a, b) for da, db in zip(back.details, on_card.details) for a, b in zip(da, db))
        assert torch.equal(decode(back, emit_u8=True), decode(on_card, emit_u8=True))
        on_cpu = container.deserialize(blob, device="cpu")
        assert container.serialize(on_cpu, quality_layers=2) == blob


@pytest.mark.cuda
def test_folder_pipeline_on_the_card(tmp_path):
    """On a card: a folder through both encode routes gives the same .wct
    bytes, and both decode routes the same PNG bytes, the device routes
    launching K2/K3 and the host routes none (``python3 chip_smoke.py``
    phase 3i runs the full-size folder)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    import cv2

    from wicca_tpu_torch.codec import batch

    (tmp_path / "src").mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        cv2.imwrite(str(tmp_path / "src" / f"im{i}.png"), rng.integers(0, 256, (96, 160, 3), dtype=np.uint8))
    for path in ("host", "device"):
        dwt_cuda.reset_launches()
        m = batch.encode_folder(tmp_path / "src", tmp_path / f"wct_{path}", levels=3, spec=QuantSpec(1.0), path=path)
        assert m[f"{path}_encoded"] == 3 and dwt_cuda.LAUNCHES["dwt_multilevel_quant"] == (3 if path == "device" else 0)
    for name in (f"im{i}.wct" for i in range(3)):
        assert (tmp_path / "wct_host" / name).read_bytes() == (tmp_path / "wct_device" / name).read_bytes()
    for path in ("host", "device"):
        dwt_cuda.reset_launches()
        m = batch.decode_folder(tmp_path / "wct_host", tmp_path / f"png_{path}", path=path)
        assert m[f"{path}_decoded"] == 3
        assert dwt_cuda.LAUNCHES["idwt_multilevel_dequant"] == (3 if path == "device" else 0)
    for name in (f"im{i}.png" for i in range(3)):
        assert (tmp_path / "png_host" / name).read_bytes() == (tmp_path / "png_device" / name).read_bytes()


@pytest.mark.cuda
def test_harness_on_the_card(tmp_path, monkeypatch):
    """On a card: the harness's icons go through K1 (one launch per bucket
    group and depth; a ``device='cpu'`` run launches none) and a zoo model on
    the card writes every CSV (``python3 chip_smoke.py`` phase 3j runs the
    full-size folder and zoo)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    import cv2

    from wicca_tpu_torch.config.constants import MODEL
    from wicca_tpu_torch.harness import ClassifierProcessor
    from wicca_tpu_torch.models import load_models

    (tmp_path / "src").mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        cv2.imwrite(str(tmp_path / "src" / f"im{i}.png"), rng.integers(0, 256, (96, 160, 3), dtype=np.uint8))
    zoo = {d: load_models({"m": ("MobileNetV2", {"shape": (64, 64)})}, device=d) for d in ("cuda", "cpu")}
    zoo["cpu"]["m"][MODEL].module.load_state_dict(zoo["cuda"]["m"][MODEL].module.state_dict())
    monkeypatch.setenv("WICCA_TPU_ICON_PATH", "device")  # frames this small would take the host route
    assert next(zoo["cuda"]["m"][MODEL].module.parameters()).device.type == "cuda"
    for d in ("cuda", "cpu"):
        dwt_cuda.reset_launches()
        ClassifierProcessor(tmp_path / "src", transform_depth=(1, 3), results_folder=tmp_path / d, log_info=False,
                            device=d).process_classifiers(zoo[d])
        assert dwt_cuda.LAUNCHES["icon"] == (2 if d == "cuda" else 0)
    for depth in (1, 3):
        name = f"depth-{depth}/m-depth-{depth}.csv"
        assert (tmp_path / "cuda" / name).is_file() and (tmp_path / "cpu" / name).is_file()
