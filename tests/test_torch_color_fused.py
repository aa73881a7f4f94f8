"""The codec with the ICT folded into K8's first and K9's last launch, and
the RCT into K6's first and K7's last, run through the host build of the
kernels (``csrc/host_emulation.h``), against the plain route the CPU takes
(the color transform in PyTorch around the plain twins). Tolerance 0:
``encode``, ``decode`` (int32 and uint8) and ``decode_at_level`` give the
same tensors either way."""

import shutil

import numpy as np
import pytest
import torch

from wicca_tpu_torch import QuantSpec, decode, decode_at_level, encode
from wicca_tpu_torch.codec import pipeline
from wicca_tpu_torch.ops import _build, dwt53_cuda, dwt97_cuda
from wicca_tpu_torch.ops.dwt_cuda import _band_steps3, contiguous_aligned


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_lib():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    return _build.host_library(cxx)


@pytest.fixture
def through_host_kernels(host_lib, monkeypatch):
    """Route the pipeline's K8/K9 calls through the host-built kernels."""
    launches = {"fwd": [], "inv": []}

    def fwd(x, steps, filt="cdf97", color="none", chroma_gain=1.0):
        launches["fwd"].append(color)
        x = contiguous_aligned(dwt97_cuda._as_input(x))
        return dwt97_cuda._launch_fwd(host_lib, x, _band_steps3(steps), filt, 0, color, chroma_gain)

    def inv(ll, details, steps, emit_u8=False, orig_k=None, filt="cdf97", recon_offset=0.5, color="none",
            chroma_gain=1.0):
        launches["inv"].append((color, emit_u8))
        orig_k = len(steps) if orig_k is None else orig_k
        return dwt97_cuda._launch_inv(host_lib, contiguous_aligned(ll.to(torch.float32)), details,
                                      _band_steps3(steps), emit_u8, orig_k, filt, recon_offset, 0, color,
                                      chroma_gain)

    monkeypatch.setattr(pipeline, "dwt97_multilevel_quant", fwd)
    monkeypatch.setattr(pipeline, "idwt97_multilevel_dequant", inv)
    return launches


@pytest.mark.parametrize("channels,gain,wavelet", [(3, 2.0, "bior4.4"), (4, 1.0, "db2")])
def test_ict_fold_matches_plain_route(through_host_kernels, channels, gain, wavelet):
    """Depth 4 (passes of 3 and 1 levels) on an odd-sized RGB or RGBA
    frame: the stream, the uint8 decode and two progressive decodes (one
    inside the first pass, one at the coarse pass's level) equal the plain
    route's, and only the first forward and the last inverse launch fold
    the ICT."""
    x = torch.from_numpy(np.random.default_rng(channels).integers(0, 256, (channels, 45, 83), dtype=np.uint8))
    kw = dict(levels=4, spec=QuantSpec(0.75), wavelet=wavelet, color="ict", chroma_gain=gain, device="cpu")
    st = encode(x, **kw)
    assert through_host_kernels["fwd"] == ["ict", "none"]
    rec = decode(st, emit_u8=True)
    assert through_host_kernels["inv"][-2:] == [("none", False), ("ict", True)]
    mid = decode_at_level(st, 2, emit_u8=True)
    coarse = decode_at_level(st, 3)
    with pytest.MonkeyPatch.context() as plain:
        plain.setattr(pipeline, "dwt97_multilevel_quant", dwt97_cuda.dwt97_multilevel_quant)
        plain.setattr(pipeline, "idwt97_multilevel_dequant", dwt97_cuda.idwt97_multilevel_dequant)
        pst = encode(x, **kw)
        want = (decode(pst, emit_u8=True), decode_at_level(pst, 2, emit_u8=True), decode_at_level(pst, 3))
    assert torch.equal(st.ll, pst.ll)
    for bands, pbands in zip(st.details, pst.details):
        for a, b in zip(bands, pbands):
            assert torch.equal(a, b)
    for got, ref in zip((rec, mid, coarse), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref), float((got.double() - ref.double()).abs().max())
    assert rec.dtype == torch.uint8 and mid.dtype == torch.uint8 and coarse.dtype == torch.float32


@pytest.fixture
def through_host_lifting(host_lib, monkeypatch):
    """Route the pipeline's K6/K7 calls through the host-built kernels, and
    record every plain RCT the pipeline runs."""
    calls = {"fwd": [], "inv": [], "plain_rct": []}

    def fwd(x, k, filt="legall5.3", color="none"):
        calls["fwd"].append(color)
        return dwt53_cuda._launch_fwd(host_lib, contiguous_aligned(dwt53_cuda._as_input(x)), k, filt, 0, color)

    def inv(ll, details, k, emit_u8=False, orig_k=None, filt="legall5.3", color="none"):
        calls["inv"].append((color, emit_u8))
        return dwt53_cuda._launch_inv(host_lib, contiguous_aligned(ll.to(torch.int32)), details, k, emit_u8,
                                      k if orig_k is None else orig_k, filt, 0, color)

    def plain(name, fn):
        def run(x):
            calls["plain_rct"].append(name)
            return fn(x)
        return run

    monkeypatch.setattr(pipeline, "dwt53_multilevel", fwd)
    monkeypatch.setattr(pipeline, "idwt53_multilevel", inv)
    monkeypatch.setattr(pipeline, "rct_fwd_codec", plain("fwd", pipeline.rct_fwd_codec))
    monkeypatch.setattr(pipeline, "rct_inv_codec", plain("inv", pipeline.rct_inv_codec))
    return calls


@pytest.mark.parametrize("channels,wavelet", [(3, "legall5.3"), (4, "legall5.3"), (3, "haar_int"),
                                              (4, "haar_int")])
def test_rct_fold_matches_plain_route(through_host_lifting, channels, wavelet):
    """Depth 4 (passes of 3 and 1 levels) on an odd-sized RGB or RGBA
    frame: the stream, the int32 and uint8 decodes and two progressive
    decodes (one inside the first pass, one at the coarse pass's level)
    equal the plain route's; only the first forward and the last inverse
    launch fold the RCT, and the folded route runs no plain RCT."""
    x = torch.from_numpy(np.random.default_rng(10 + channels).integers(0, 256, (channels, 45, 83), dtype=np.uint8))
    kw = dict(levels=4, wavelet=wavelet, color="rct", device="cpu")
    calls = through_host_lifting
    st = encode(x, **kw)
    assert calls["fwd"] == ["rct", "none"]
    rec = decode(st, emit_u8=True)
    assert calls["inv"][-2:] == [("none", False), ("rct", True)]
    rec32 = decode(st)
    assert calls["inv"][-1] == ("rct", False)
    mid = decode_at_level(st, 2, emit_u8=True)
    coarse = decode_at_level(st, 3)
    assert calls["plain_rct"] == []
    with pytest.MonkeyPatch.context() as plain:
        plain.setattr(pipeline, "dwt53_multilevel", dwt53_cuda.dwt53_multilevel)
        plain.setattr(pipeline, "idwt53_multilevel", dwt53_cuda.idwt53_multilevel)
        pst = encode(x, **kw)
        want = (decode(pst, emit_u8=True), decode(pst), decode_at_level(pst, 2, emit_u8=True),
                decode_at_level(pst, 3))
    assert torch.equal(st.ll, pst.ll)
    for bands, pbands in zip(st.details, pst.details):
        for a, b in zip(bands, pbands):
            assert torch.equal(a, b)
    for got, ref in zip((rec, rec32, mid, coarse), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref), float((got.double() - ref.double()).abs().max())
    assert torch.equal(rec, x) and torch.equal(rec32, x.to(torch.int32))
    assert rec.dtype == torch.uint8 and mid.dtype == torch.uint8 and coarse.dtype == torch.int32
