"""The reference's namespace on the port (``wicca_tpu_torch.compat``) and the
package-level names, against ``wicca_tpu`` on the CPU.

Every public name of every ``wicca_tpu.compat`` module resolves in its
counterpart; ``get_padded_copy`` and the compat ``HaarCoder`` icon equal the
JAX package's in every border mode, odd sizes and grayscale included, and
``get_padded_copy`` follows the device rule;
``quantize_pyramid``/``dequantize_pyramid`` equal JAX's bit for bit on the
same pyramid; ``preserve_depth`` restores the depth as JAX's does; the
package ``__init__`` re-exports match. Tolerance 0 throughout.
"""

import importlib
import pkgutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wicca_tpu.compat as jcompat
from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.compat.data_loader import get_padded_copy as jax_padded
from wicca_tpu.compat.wavelet_coder import HaarCoder as JaxHaarCoder
from wicca_tpu.core import haar as jhaar
from wicca_tpu.core import quant as jquant
from wicca_tpu_torch.compat.data_loader import get_padded_copy
from wicca_tpu_torch.compat.wavelet_coder import HaarCoder
from wicca_tpu_torch.core import quant

JAX_COMPAT = sorted(m.name for m in pkgutil.walk_packages(jcompat.__path__, "wicca_tpu.compat."))
# the port's modules, imported as walking the JAX package imported its own
# (a submodule is an attribute of its package once imported)
PORT_COMPAT = [importlib.import_module(n.replace("wicca_tpu", "wicca_tpu_torch", 1)) for n in JAX_COMPAT]
BORDERS = [0, 1, 2, 3, 4, "constant", "replicate", "reflect", "reflect101", "wrap"]


def public(module) -> set:
    return {n for n in dir(module) if not n.startswith("_") and n != "annotations"}


@pytest.mark.parametrize("name", ["wicca_tpu.compat", *JAX_COMPAT])
def test_every_compat_name_resolves(name):
    want = public(importlib.import_module(name))
    port = importlib.import_module(name.replace("wicca_tpu", "wicca_tpu_torch", 1))
    assert sorted(want - public(port)) == []


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("shape,ratio", [((37, 50, 3), 8), ((45, 67), 4), ((31, 17, 4), 16), ((32, 48, 3), 16),
                                         ((5, 9, 3), 3)])
def test_get_padded_copy_equals_jax(shape, ratio, border):
    img = np.random.default_rng(len(shape) * ratio).integers(0, 256, shape, np.uint8)
    want = np.asarray(jax_padded(img, ratio, border, 7))
    got = get_padded_copy(img, ratio, border, 7, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and np.array_equal(got, want)
    tensor = get_padded_copy(torch.from_numpy(img), ratio, border, 7)  # a tensor is padded where it lies
    assert isinstance(tensor, torch.Tensor) and np.array_equal(tensor.numpy(), want)


def test_get_padded_copy_follows_the_device_rule(monkeypatch):
    """Numpy input goes to the card unless ``device='cpu'``: with no card the
    call raises; a tensor on the CPU asked onto another device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((5, 9, 3), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_padded_copy(img, 4)
    with pytest.raises(ValueError, match="lies on cpu"):
        get_padded_copy(torch.from_numpy(img), 4, device="cuda")
    assert get_padded_copy(img, 4, device="cpu").shape == (8, 12, 3)


@pytest.mark.parametrize("border", [0, 1, 2, 4, "wrap"])
@pytest.mark.parametrize("shape,depth", [((37, 50, 3), 3), ((45, 67), 2), ((64, 96, 3), 5), ((9, 13, 3), 4)])
def test_compat_haar_icon_equals_jax(shape, depth, border):
    img = np.random.default_rng(depth).integers(0, 256, shape, np.uint8)
    want = np.asarray(JaxHaarCoder().get_small_copy(img, depth, border, 11))
    got = HaarCoder().get_small_copy(img, depth, border, 11, device="cpu")
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("spec_kw", [{}, {"base_step": 2.0, "level_gain": 1.5, "ll_step": 0.5, "hh_gain": 1.25},
                                     {"base_step": 0.75, "coeff_dtype": "int16"}])
def test_quantize_pyramid_equals_jax(spec_kw):
    x = np.random.default_rng(9).uniform(0, 255, (3, 40, 56)).astype(np.float32)
    jpyr = jhaar.dwt2(jnp.asarray(x), 3)
    kw = dict(spec_kw)
    dtype = kw.pop("coeff_dtype", "int32")
    jspec = jquant.QuantSpec(coeff_dtype=getattr(jnp, dtype), **kw)
    spec = quant.QuantSpec(coeff_dtype=getattr(torch, dtype), **kw)
    pyr = quant.Pyramid(ll=torch.tensor(np.asarray(jpyr.ll)),
                        details=tuple(tuple(torch.tensor(np.asarray(b)) for b in bands) for bands in jpyr.details),
                        wavelet=jpyr.wavelet, orig_shape=jpyr.orig_shape)
    for want, got in ((jquant.quantize_pyramid(jpyr, jspec), quant.quantize_pyramid(pyr, spec)),
                      (jquant.dequantize_pyramid(jquant.quantize_pyramid(jpyr, jspec), jspec),
                       quant.dequantize_pyramid(quant.quantize_pyramid(pyr, spec), spec))):
        assert (got.wavelet, got.orig_shape, got.levels) == (want.wavelet, want.orig_shape, len(want.details))
        for g, w in zip([got.ll, *[b for bands in got.details for b in bands]],
                        [want.ll, *[b for bands in want.details for b in bands]]):
            w = np.asarray(w)
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype) and np.array_equal(g.numpy(), w)


def test_preserve_depth_behaves_as_jax():
    from wicca_tpu.utils import preserve_depth as jax_preserve
    from wicca_tpu_torch.utils import preserve_depth

    def sweep_class(deco):
        class Sweep:
            depth = 3

            @deco
            def run(self, depths, fail=False):
                """Sweeps the depths."""
                seen = []
                for d in depths:
                    self.depth = d
                    seen.append(self.depth)
                if fail:
                    raise KeyError("stop")
                return seen

        return Sweep

    for deco in (jax_preserve, preserve_depth):
        s = sweep_class(deco)()
        assert s.run((1, 2, 5)) == [1, 2, 5] and s.depth == 3
        with pytest.raises(KeyError):
            s.run((4,), fail=True)
        assert s.depth == 3 and type(s).run.__doc__ == "Sweeps the depths." and type(s).run.__name__ == "run"


def test_package_level_names():
    import wicca_tpu.core as jcore
    import wicca_tpu.data as jdata
    import wicca_tpu.native as jnative
    import wicca_tpu.utils as jutils
    import wicca_tpu_torch.core as core
    import wicca_tpu_torch.data as data
    import wicca_tpu_torch.native as native
    import wicca_tpu_torch.utils as utils
    from wicca_tpu_torch.codec import container
    from wicca_tpu_torch.models import registry
    from wicca_tpu_torch.native import rice

    assert core.__all__ == jcore.__all__ and all(hasattr(core, n) for n in core.__all__)
    for jmod, mod in ((jdata, data), (jutils, utils), (jnative, native)):
        # names, not submodules (which of those a process has imported varies)
        names = {n for n in public(jmod) if not isinstance(getattr(jmod, n), types.ModuleType)}
        assert sorted(names - public(mod)) == []
    assert data.load_models is registry.load_models and data.load_single_model is registry.load_single_model
    assert container.native_available is rice.native_available is native.native_available
    assert native.native_available() is True  # the port's own entropy library builds here
    codes = np.arange(-50, 50, dtype=np.int8)
    assert np.array_equal(native.rice_decode(native.rice_encode(codes), codes.size, np.int8), codes)
