"""K8/K9's plain twins (``wicca_tpu_torch.ops.dwt97_cuda``) against
``wicca_tpu.ops.dwt97_pallas`` on the CPU, where JAX runs its Pallas kernels
in interpret mode, as its own tests run them.

The port rounds once per operation in the Pallas kernel's op order; the
reference's XLA build contracts some lifting products into fused
multiply-adds, and which ones depends on the shape. So the two agree within
a stated tolerance, not bit for bit (the CUDA kernels equal the twins bit
for bit: ``test_torch_kernels_host.py``, ``chip_smoke.py``):

* LL and float32 reconstructions: ``atol 1e-3``;
* codes: differ by at most 1, in at most 1e-3 of all the codes of a pass;
* uint8 reconstructions: differ by at most 1, in at most 1e-3 of the pixels.

Largest values measured over this file's cases and those of
``test_torch_codec_float.py`` and ``test_torch_codec_global.py``: 3.3e-4
(a float32 decode), codes 1.3e-4 of a pass (1 of 7,650), uint8 1.6e-4 of
the pixels (1 of 6,300). A wider probe (both filters, k = 1 and 3,
seams both ways) reached 7.6e-4 of the uint8 pixels once (225 of 294,912,
a level-1 pass from uint8 at step 0.75, whose reconstructions sit close to
whole numbers).

The inverse runs on the same (JAX) codes in both packages. Shapes cross the
(512, 1024) tile seams in each direction, and a batched odd shape is padded
to a multiple of ``2**k``."""

import numpy as np
import pytest
import torch

from wicca_tpu.ops.dwt97_pallas import dwt97_multilevel_quant_pallas, idwt97_multilevel_dequant_pallas
from wicca_tpu_torch.core.pad import pad_to_multiple
from wicca_tpu_torch.ops import dwt97_cuda

ATOL = 1e-3
MISMATCH_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads cost far more
    than they save when the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

STEP_SETS = {
    "1.0": lambda k: tuple(1.0 for _ in range(k)),
    "0.75": lambda k: tuple(0.75 for _ in range(k)),
    "hh1.5": lambda k: tuple((0.75 * 1.5**i, 0.75 * 1.5**i, 0.75 * 1.5**i * 1.5) for i in range(k)),
}

CASES = {
    # (filt, k, input, steps, shape): one seam shape per filter at k = 3
    # (whose passes cover the seam handling of k = 1-2); k = 1-2 on the
    # batched odd shape
    "cdf97-k3-u8-hh1.5-rows": ("cdf97", 3, "u8", "hh1.5", (2, 1100, 96)),
    "db2-k3-f32-0.75-cols": ("db2", 3, "f32", "0.75", (1, 72, 1100)),
    "cdf97-k2-f32-1.0-batched": ("cdf97", 2, "f32", "1.0", (2, 3, 37, 23)),
    "db2-k1-u8-hh1.5-batched": ("db2", 1, "u8", "hh1.5", (2, 3, 37, 23)),
}


def _input(src: str, shape, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, dtype=np.uint8) if src == "u8" else (rng.random(shape) * 300 - 20).astype(np.float32)
    return pad_to_multiple(torch.from_numpy(x), 1 << k).numpy()


def assert_close(got, want, what: str = "") -> None:
    """float32 within ATOL; integer codes and uint8 pixels within 1, in at
    most MISMATCH_SHARE of the entries of all the pairs together. ``got``
    and ``want`` are a tensor and an array, or equal-length lists of them
    (every code plane of a pass)."""
    pairs = list(zip(got, want)) if isinstance(got, (list, tuple)) else [(got, want)]
    mismatched = total = 0
    for g, w in pairs:
        w, g = np.asarray(w), g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape, w.shape)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=what)
            continue
        diff = np.abs(g.astype(np.int64) - w.astype(np.int64))
        assert diff.max(initial=0) <= 1, (what, int(diff.max()))
        mismatched += int(np.count_nonzero(diff))
        total += diff.size
    assert mismatched <= MISMATCH_SHARE * total, (what, mismatched, total)


def flat(details) -> list:
    return [b for bands in details for b in bands]


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", CASES)
def test_twins_match_pallas(case):
    filt, k, src, steps_name, shape = CASES[case]
    x = _input(src, shape, k, seed=k + len(shape))
    steps = STEP_SETS[steps_name](k)
    jll, jdets = dwt97_multilevel_quant_pallas(x, steps, filt=filt)
    ll, dets = dwt97_cuda.dwt97_multilevel_quant_plain(torch.from_numpy(x), steps, filt)
    assert_close(ll, jll, "ll")
    assert_close(flat(dets), flat(jdets), "codes")

    # the inverse on the same codes: float32 and uint8 out, two offsets
    tll, tdets = _torch(jll), [tuple(_torch(b) for b in bands) for bands in jdets]
    for emit_u8, off in ((False, 0.3), (True, 0.5)):
        want = idwt97_multilevel_dequant_pallas(jll, jdets, steps, emit_u8=emit_u8, filt=filt, recon_offset=off)
        got = dwt97_cuda.idwt97_multilevel_dequant_plain(tll, tdets, steps, emit_u8, filt=filt, recon_offset=off)
        assert_close(got, want, f"inverse emit_u8={emit_u8} offset={off}")
    # partial passes of a progressive decode: the coarse kk levels, clamped
    # on the encoder's k-level tiles
    for kk in range(1, k):
        want = idwt97_multilevel_dequant_pallas(jll, jdets[k - kk:], steps[k - kk:], orig_k=k, filt=filt)
        got = dwt97_cuda.idwt97_multilevel_dequant_plain(tll, tdets[k - kk:], steps[k - kk:], orig_k=k, filt=filt)
        assert_close(got, want, f"partial {kk} of {k}")


def test_wrapper_checks():
    x = torch.zeros((1, 12, 12), dtype=torch.uint8)
    for steps, filt in (((1.0,) * 3, "cdf97"), ((1.0,) * 4, "db2"), ((1.0,), "legall5.3")):
        with pytest.raises(ValueError):
            dwt97_cuda.dwt97_multilevel_quant(x, steps, filt)
    ll, dets = dwt97_cuda.dwt97_multilevel_quant(x, (1.0, 1.0))
    assert ll.dtype == torch.float32 and tuple(ll.shape) == (1, 3, 3)
    assert all(b.dtype == torch.int16 for bands in dets for b in bands)
    with pytest.raises(ValueError):
        dwt97_cuda.idwt97_multilevel_dequant(ll, dets, (1.0, 1.0), orig_k=1)
    with pytest.raises(ValueError):
        dwt97_cuda.idwt97_multilevel_dequant(ll, dets, (1.0,))
    with pytest.raises(ValueError):
        dwt97_cuda.idwt97_multilevel_dequant(ll, [tuple(b.to(torch.int32) for b in dets[0]), dets[1]], (1.0, 1.0))
    rec = dwt97_cuda.idwt97_multilevel_dequant(ll, dets, (1.0, 1.0), emit_u8=True)
    assert rec.dtype == torch.uint8 and tuple(rec.shape) == (1, 12, 12)
