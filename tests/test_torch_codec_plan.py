"""The launch plans of the fused 8-bit Haar path (``codec/pipeline.py``):
``encode`` and ``decode`` through the plans on the CPU, their K2/K3
launches run by the host build of the kernels (``csrc/host_emulation.h``,
stream 0), held against the pass code the other paths take (the same
kernels, through the pipeline's per-pass code) and against the plain twins.
Tolerance 0. Also: the plans' counters, that no plan holds a buffer, the
copies and refusals of the pass code, which streams keep the pass code,
and the launch counts."""

import contextlib
import dataclasses
import shutil
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wicca_tpu_torch import QuantSpec, decode, encode
from wicca_tpu_torch.codec import pipeline
from wicca_tpu_torch.codec.roi import apply_roi
from wicca_tpu_torch.ops import _build
from wicca_tpu_torch.ops import dwt_cuda as ops
from wicca_tpu_torch.utils import timing


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
def planned(host_lib, monkeypatch):
    """CPU tensors take the launch plans, launched by the host-built kernels."""
    monkeypatch.setitem(pipeline._PLAN_LAUNCH, "cpu", lambda index, launch, *args: launch(host_lib, *args, 0))
    pipeline._ENCODE_PLANS.clear()
    pipeline._DECODE_PLANS.clear()
    timing.reset()
    yield
    pipeline._ENCODE_PLANS.clear()
    pipeline._DECODE_PLANS.clear()
    timing.reset()


@contextlib.contextmanager
def _pass_code(host_lib):
    """The pipeline's per-pass code, its K2/K3 calls through the host-built kernels."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delitem(pipeline._PLAN_LAUNCH, "cpu", raising=False)
        mp.setattr(pipeline, "dwt_multilevel_quant",
                   lambda x, steps: ops._launch_dwt(host_lib, x, ops._band_steps3(steps), 0))
        mp.setattr(pipeline, "idwt_multilevel_dequant",
                   lambda ll, dets, steps, emit_u8=False, recon_offset=0.5: ops._launch_idwt(
                       host_lib, ll, dets, ops._band_steps3(steps), emit_u8, recon_offset, 0))
        yield


@contextlib.contextmanager
def _plain():
    """The route of CPU tensors: the plain twins."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delitem(pipeline._PLAN_LAUNCH, "cpu", raising=False)
        yield


@contextlib.contextmanager
def _counting():
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        yield


def _counters() -> dict:
    c = timing.snapshot()["counters"]
    return {k: c[k] for k in ("codec.plan_hit", "codec.plan_miss") if k in c}


def _tensors(stream):
    return [stream.ll] + [b for bands in stream.details for b in bands]


def _equal(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.double() - want.double()).abs().max())


def _streams_equal(a, b) -> None:
    assert (a.levels, a.orig_shape, a.spec, a.wavelet, a.color, a.bit_depth, a.layout) == (
        b.levels, b.orig_shape, b.spec, b.wavelet, b.color, b.bit_depth, b.layout)
    assert len(a.details) == len(b.details)
    for x, y in zip(_tensors(a), _tensors(b)):
        _equal(x, y)


def _frame(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "u8":
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    return torch.from_numpy((rng.random(shape) * 300 - 20).astype(np.float32))


# depth, lead dims, (H, W), input, spec: every depth; sizes that pad and
# sizes that do not; int8 and int16 codes, mixed across levels; hh_gain != 1
CASES = [
    (1, (), (37, 71), "u8", QuantSpec(base_step=1.0)),
    (2, (3,), (40, 64), "f32", QuantSpec(base_step=0.75)),
    (3, (2, 3), (45, 83), "u8", QuantSpec(base_step=0.75, level_gain=1.5, hh_gain=1.5)),
    (4, (3,), (64, 48), "f32", QuantSpec(base_step=1.0, hh_gain=2.0)),
    (5, (3,), (128, 96), "u8", QuantSpec(base_step=1.0)),
    (6, (), (70, 130), "u8", QuantSpec(base_step=0.5, level_gain=2.0)),
    (7, (2, 3), (128, 128), "f32", QuantSpec(base_step=0.75, hh_gain=1.5)),
    (8, (), (250, 260), "u8", QuantSpec(base_step=2.0, level_gain=1.25, hh_gain=1.5)),
]


@pytest.mark.parametrize("levels,lead,hw,src,spec", CASES, ids=[f"depth{c[0]}" for c in CASES])
def test_plans_match_the_pass_code_and_the_plain_twins(planned, host_lib, levels, lead, hw, src, spec):
    x = _frame(lead + hw, src, levels)
    with _counting():
        st = encode(x, levels=levels, spec=spec)
        recs = {(u8, off): decode(st, emit_u8=u8, recon_offset=off) for u8 in (False, True) for off in (0.5, 0.3)}
    assert _counters() == {"codec.plan_miss": 5}  # the encode and four decode settings, every one through a plan
    with _pass_code(host_lib):
        pst = encode(x, levels=levels, spec=spec)
        precs = {key: decode(pst, emit_u8=key[0], recon_offset=key[1]) for key in recs}
    with _plain():
        tst = encode(x, levels=levels, spec=spec)
        trecs = {key: decode(tst, emit_u8=key[0], recon_offset=key[1]) for key in recs}
    _streams_equal(st, pst)
    _streams_equal(st, tst)
    assert st.orig_shape == hw and st.ll.shape == lead + tuple(-(-n // 2**levels) for n in hw)
    for key, rec in recs.items():
        assert rec.shape == lead + hw and rec.dtype == (torch.uint8 if key[0] else torch.float32)
        _equal(rec, precs[key])
        _equal(rec, trecs[key])


def test_a_second_call_hits_and_a_new_geometry_misses(planned):
    spec = QuantSpec(base_step=1.0)
    with _counting():
        decode(encode(_frame((3, 64, 96), "u8", 1), levels=5, spec=spec), emit_u8=True)
    assert _counters() == {"codec.plan_miss": 2}
    with _counting():
        decode(encode(_frame((3, 64, 96), "u8", 2), levels=5, spec=spec), emit_u8=True)
    assert _counters() == {"codec.plan_hit": 2}
    with _counting():
        st = encode(_frame((3, 64, 96), "f32", 3), levels=5, spec=spec)  # another dtype
        decode(st, emit_u8=True)  # the stream's geometry is the uint8 frame's: a hit
        decode(encode(_frame((3, 64, 100), "u8", 4), levels=5, spec=spec))  # another size
        encode(_frame((3, 64, 96), "u8", 5), levels=4, spec=spec)  # another depth
        encode(_frame((3, 64, 96), "u8", 6), levels=5, spec=QuantSpec(base_step=0.5))  # another spec
        decode(st, emit_u8=True, recon_offset=0.3)  # another setting
    assert _counters() == {"codec.plan_miss": 6, "codec.plan_hit": 1}


def test_the_cache_keeps_the_last_64_geometries():
    built = []
    cache = pipeline._PlanCache(lambda n: built.append(n) or ("plan", n))
    for n in range(65):
        assert cache.get((n,)) == ("plan", n)
    assert cache.get((64,)) == ("plan", 64) and cache.get((1,)) == ("plan", 1) and len(built) == 65
    assert cache.get((0,)) == ("plan", 0) and built[-1] == 0  # 0 went first; back, it pushes out 2
    cache.get((3,))
    assert built[-1] == 0  # still held
    cache.get((2,))
    assert built[-1] == 2 and len(built) == 67


def test_the_cache_holds_under_threads():
    """Threads sharing a small cache: every call gets its key's plan, each
    call counts once, and the cache never holds more than its size."""
    size, keys, calls = 8, 12, 400
    cache = pipeline._PlanCache(lambda n: ("plan", n), size=size)
    seen, errors = [], []

    def work(seed):
        try:
            rng = np.random.default_rng(seed)
            for n in rng.integers(0, keys, calls):
                assert cache.get((int(n),)) == ("plan", int(n))
                with cache._lock:
                    seen.append(len(cache._plans))
        except AssertionError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    timing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert max(seen) <= size and len(cache._plans) == size
    assert sum(_counters().values()) == 16 * calls
    timing.reset()


def test_a_held_stream_never_changes_under_later_calls(planned):
    spec = QuantSpec(base_step=0.75)
    a = encode(_frame((3, 64, 96), "u8", 1), levels=5, spec=spec)
    ra = decode(a, emit_u8=True)
    keep = [t.clone() for t in _tensors(a)] + [ra.clone()]
    b = encode(_frame((3, 64, 96), "u8", 2), levels=5, spec=spec)
    rb = decode(b, emit_u8=True)
    decode(a, emit_u8=True)
    for got, want in zip(_tensors(a) + [ra], keep):
        _equal(got, want)
    assert not {t.data_ptr() for t in _tensors(a) + [ra]} & {t.data_ptr() for t in _tensors(b) + [rb]}
    assert not torch.equal(ra, rb)
    # a level's three bands are views of one allocation here: its own, fresh each call
    lh, hl, hh = a.details[0]
    assert lh.untyped_storage().data_ptr() == hh.untyped_storage().data_ptr() == lh.data_ptr()
    assert b.details[0][0].untyped_storage().data_ptr() != lh.data_ptr()


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    out = buf[1 : 1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 and out.is_contiguous()
    return out


def _strided(t: torch.Tensor) -> torch.Tensor:
    """A non-contiguous view holding ``t``'s values."""
    out = t.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not out.is_contiguous()
    return out


def test_inputs_the_kernels_cannot_take_are_copied_as_the_pass_code_copies_them(planned):
    spec = QuantSpec(base_step=1.0)
    x = _frame((3, 64, 96), "u8", 7)
    with _plain():
        want = encode(x, levels=5, spec=spec)
        want_rec = decode(want, emit_u8=True)
    for odd in (_misaligned(x), _strided(x), torch.cat([x, x], dim=-1)[..., :96]):
        with _counting():
            st = encode(odd, levels=5, spec=spec)
        assert "codec.plan_miss" in _counters() or "codec.plan_hit" in _counters()
        _streams_equal(st, want)
    details = tuple(tuple(f(b) for f, b in zip((_misaligned, _strided, _misaligned), bands)) for bands in want.details)
    for ll in (_misaligned(want.ll), _strided(want.ll)):
        odd = dataclasses.replace(want, ll=ll, details=details)
        with _counting():
            rec = decode(odd, emit_u8=True)
        assert sum(_counters().values()) == 1
        _equal(rec, want_rec)


def _refusal(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def test_what_the_pass_code_refuses_the_plans_refuse_with_its_message(planned):
    x = _frame((3, 64, 96), "u8", 8)
    st = encode(x, levels=3, spec=QuantSpec(base_step=1.0))
    bad = dataclasses.replace(st, details=(st.details[0], tuple(b[..., :-2, :] for b in st.details[1]), st.details[2]))
    mixed = dataclasses.replace(st, details=(st.details[0], (st.details[1][0].to(torch.int16),) + st.details[1][1:],
                                             st.details[2]))
    short = dataclasses.replace(st, details=(st.details[0], st.details[1][:2], st.details[2]))
    calls = [lambda: encode(x, levels=0), lambda: encode(x, levels=3, mode="nearest"),
             lambda: encode(torch.zeros((3, 0, 64), dtype=torch.uint8), levels=2),
             lambda: decode(bad), lambda: decode(mixed, emit_u8=True), lambda: decode(short)]
    planned_refusals = [_refusal(call) for call in calls]
    with _plain():
        assert planned_refusals == [_refusal(call) for call in calls]


def test_streams_off_the_plain_haar_path_keep_the_pass_code(planned):
    """ROI-coded, R-D-divided, colour-transformed and integer-wavelet
    streams: no plan is built or used, and they decode as the plain route
    does."""
    x = _frame((3, 64, 96), "u8", 9)
    spec = QuantSpec(base_step=1.0)
    mask = np.zeros((64, 96), dtype=bool)
    mask[8:40, 16:64] = True
    with _plain():
        plain = encode(x, levels=4, spec=spec)
    cases = [lambda: apply_roi(plain, mask), lambda: dataclasses.replace(plain, band_div=(2,) * 12),
             lambda: encode(x, levels=4, spec=spec, color="ict"), lambda: encode(x, levels=4, wavelet="haar_int")]
    for make in cases:
        with _plain():
            want_st = make()
            want = decode(want_st, emit_u8=True)
        with _counting():
            st = make()
            rec = decode(st, emit_u8=True)
        assert _counters() == {}
        _streams_equal(st, want_st)
        _equal(rec, want)


def test_a_depth5_roundtrip_counts_two_launches_of_each_kernel(planned):
    ops.reset_launches()
    decode(encode(_frame((3, 64, 96), "u8", 10), levels=5, spec=QuantSpec(base_step=1.0)), emit_u8=True)
    assert ops.LAUNCHES["dwt_multilevel_quant"] == 2 and ops.LAUNCHES["idwt_multilevel_dequant"] == 2
    assert sum(ops.LAUNCHES.values()) == 4
