"""The port's classification harness (``wicca_tpu_torch.harness``,
``analysis``, ``core/icon_host``, ``models/imagenet``, ``utils``) against
the JAX package's, with ``device='cpu'`` (the icons then run K1's plain
twin, the reconstructions the codec's plain twins).

Tolerance 0 throughout: the same CSV bytes as the JAX harness under a
deterministic numpy classifier both harnesses share (icons, reconstructions,
resizes, decoding and the results layer all enter the bytes), the same
per-image rows for SimpleCNN with weights carried across, bit-equal icons on
the host and device routes, and the reference quirks of
``tests/test_harness.py`` and ``tests/test_quirks.py``. The ``bior4.4`` +
``ict`` reconstructions may differ from the JAX package's within the
tolerance of ``tests/test_torch_dwt97.py``; the CSVs on this folder still
agree byte for byte.
"""

import json
import logging
import math
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from tests.test_torch_dwt97 import one_torch_thread  # noqa: F401 (fixture)
from wicca_tpu.core.icon_host import icons_multi as jax_icons_multi
from wicca_tpu.core.quant import QuantSpec as JaxQuantSpec
from wicca_tpu.harness.processor import ClassifierProcessor as JaxProcessor
from wicca_tpu.models.imagenet import decode_predictions as jax_decode
from wicca_tpu.models.registry import load_models as jax_load_models
from wicca_tpu.utils.timing import format_proc_time as jax_format_proc_time
from wicca_tpu_torch.analysis.results import (
    compare_summaries,
    extract_from_comparison,
    get_short_comparison,
    load_summary_results,
    save_results,
    summarize,
)
from wicca_tpu_torch.codec import transfer
from wicca_tpu_torch.config.constants import (
    DEC_PRED,
    ICON,
    MODEL,
    PRE_INP,
    SHAPE,
    SIM_BEST_CLASS,
    SIM_CLASSES,
    SIM_CLASSES_PERC,
    SOURCE,
)
from wicca_tpu_torch.core.icon_host import icon_host, icons_multi
from wicca_tpu_torch.core.quant import QuantSpec
from wicca_tpu_torch.harness import processor
from wicca_tpu_torch.harness.processor import ClassifierProcessor
from wicca_tpu_torch.models.imagenet import decode_predictions
from wicca_tpu_torch.models.interop import from_flax_variables
from wicca_tpu_torch.models.registry import load_models, load_single_model
from wicca_tpu_torch.ops import dwt_cuda
from wicca_tpu_torch.utils.timing import StageTimer, format_proc_time, trace

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def data_folder(tmp_path_factory):
    import cv2

    folder = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i in range(6):
        img = rng.integers(0, 256, size=(96 + 16 * i, 128, 3), dtype=np.uint8)
        cv2.imwrite(str(folder / f"img_{i}.png"), img)
    (folder / "notes.txt").write_text("not an image")  # must be ignored
    return folder


@pytest.fixture(scope="module")
def classifiers():
    clfs = load_models({"tiny": ("SimpleCNN", {"shape": (64, 64)})}, **CPU)
    assert clfs["tiny"] is not None
    for key in (MODEL, PRE_INP, DEC_PRED, SHAPE):
        assert key in clfs["tiny"]
    return clfs


def deterministic_classifier(decode, shape=(32, 32), seed=5):
    """A numpy classifier both harnesses share: logits are a fixed random
    projection of the resized pixels (float64, so the BLAS order does not
    reach the float32 logits)."""
    w = np.random.default_rng(seed).standard_normal((shape[0] * shape[1] * 3, 1000))

    def model(batch):
        return (np.asarray(batch, np.float64).reshape(len(batch), -1) @ w).astype(np.float32)

    return {MODEL: model, PRE_INP: lambda x: np.asarray(x, np.float32) / 255.0, DEC_PRED: decode, SHAPE: shape}


def _run_both(data_folder, tmp_path, depths, jax_clfs, port_clfs, **kw):
    common = dict(transform_depth=depths, interpolation=3, top_classes=5, log_info=False, batch_size=4)
    JaxProcessor(data_folder, results_folder=tmp_path / "jax", **common, **kw).process_classifiers(jax_clfs)
    port_kw = {k: (QuantSpec(v.base_step) if k == "codec_spec" else v) for k, v in kw.items()}
    ClassifierProcessor(data_folder, results_folder=tmp_path / "port", **common, **port_kw,
                        **CPU).process_classifiers(port_clfs)
    return tmp_path / "jax", tmp_path / "port"


def _same_csvs(jax_dir, port_dir, depths, names):
    for depth in depths:
        for name in names:
            for suffix in (f"{name}-depth-{depth}.csv", f"{name}-summary-depth-{depth}.csv"):
                a = (jax_dir / f"depth-{depth}" / suffix).read_bytes()
                assert (port_dir / f"depth-{depth}" / suffix).read_bytes() == a, suffix
        metrics = [json.loads((d / f"depth-{depth}" / "run-metrics.json").read_text()) for d in (jax_dir, port_dir)]
        assert set(metrics[0]) == set(metrics[1]) == {"depth", "classifiers", "images_pixels", "wall_s",
                                                      "megapixels_per_s", "stage_seconds"}
        # the port adds the main thread's wait on the classifiers and the results' writing
        assert set(metrics[0]["stage_seconds"]) | {"wait_classifiers", "results"} == set(metrics[1]["stage_seconds"])
        for key in ("depth", "classifiers", "images_pixels"):
            assert metrics[0][key] == metrics[1][key]


@pytest.mark.parametrize("compare", [
    dict(),
    dict(compare="reconstruction", codec_spec=JaxQuantSpec(base_step=1.0)),
    dict(compare="reconstruction", codec_wavelet="legall5.3", codec_color="rct"),
    dict(compare="reconstruction", codec_spec=JaxQuantSpec(base_step=1.0), codec_wavelet="bior4.4",
         codec_color="ict"),
], ids=["icon", "reconstruction-haar", "reconstruction-legall53-rct", "reconstruction-bior44-ict"])
def test_csv_bytes_equal_the_jax_harness(data_folder, tmp_path, compare):
    """The same folder through both harnesses under one deterministic
    classifier: every CSV equal byte for byte, run-metrics.json with the
    same keys and counts."""
    depths = (1, 2) if not compare else (2,)
    jax_dir, port_dir = _run_both(data_folder, tmp_path, depths, {"det": deterministic_classifier(jax_decode)},
                                  {"det": deterministic_classifier(decode_predictions)}, **compare)
    _same_csvs(jax_dir, port_dir, depths, ["det"])


def test_simplecnn_with_carried_weights_gives_the_same_rows(data_folder, tmp_path):
    """The JAX registry's SimpleCNN and the port's with its weights carried
    across (``from_flax_variables``) give the same per-image rows."""
    jax_clfs = jax_load_models({"tiny": ("SimpleCNN", {"shape": (32, 32)})})
    port = load_models({"tiny": ("SimpleCNN", {"shape": (32, 32)})}, **CPU)
    state = from_flax_variables("SimpleCNN", jax_clfs["tiny"][MODEL].params, (32, 32))
    port["tiny"][MODEL].module.load_state_dict(state, strict=True)
    jax_dir, port_dir = _run_both(data_folder, tmp_path, (1, 3), jax_clfs, port)
    _same_csvs(jax_dir, port_dir, (1, 3), ["tiny"])


def test_metrics_hand_computed():
    mk = lambda names: [[("n0", n, 0.5) for n in names]]  # noqa: E731
    results = {
        "a.png": {SOURCE: mk(["cat", "dog", "fox"]), ICON: mk(["cat", "dog", "elk"])},
        "b.png": {SOURCE: mk(["cat", "dog", "fox"]), ICON: mk(["owl", "cat", "elk"])},
    }
    df = get_short_comparison(results, top=3)
    assert df[SIM_CLASSES].tolist() == [2, 1]
    assert df[SIM_CLASSES_PERC].tolist() == pytest.approx([66.666, 33.333], abs=0.01)
    assert df[SIM_BEST_CLASS].tolist() == [100.0, 0.0]


def test_processor_end_to_end(data_folder, classifiers, tmp_path):
    proc = ClassifierProcessor(data_folder, transform_depth=(1, 2), interpolation=3, top_classes=5,
                               results_folder=tmp_path / "results", log_info=False, batch_size=4, **CPU)
    out = proc.process_classifiers(classifiers)
    assert set(out) == {"tiny"}
    name, sum_df = out["tiny"]
    assert name == "tiny" and list(sum_df.index) == ["mean", "min", "max"]
    for depth in (1, 2):
        base = tmp_path / "results" / f"depth-{depth}"
        assert (base / f"tiny-summary-depth-{depth}.csv").is_file()
        df = pd.read_csv(base / f"tiny-depth-{depth}.csv")
        assert {SIM_CLASSES, SIM_CLASSES_PERC, SIM_BEST_CLASS} <= set(df.columns)
        assert len(df) == 6  # txt file skipped
    assert load_summary_results(tmp_path / "results", "tiny", 1) is not None
    comp = compare_summaries(tmp_path / "results", ["tiny"], (1, 2))
    names, vals = extract_from_comparison(comp, SIM_CLASSES_PERC)
    assert names == ["tiny", "tiny"] and all(0.0 <= v <= 100.0 for v in vals)


def test_log_init_info_prints_the_dataset(data_folder, tmp_path, capsys):
    ClassifierProcessor(data_folder, transform_depth=(1, 2), results_folder=tmp_path / "r", **CPU)
    out = capsys.readouterr().out
    assert "Images found: 6" in out and "Mean image dimensions (n=6): 128x136" in out
    assert "Transform depths: (1, 2)" in out


def test_process_single_classifier(data_folder, classifiers, tmp_path):
    proc = ClassifierProcessor(data_folder, transform_depth=1, top_classes=3, results_folder=tmp_path / "r2",
                               log_info=False, **CPU)
    assert "tiny" in proc.process_single_classifier("tiny", classifiers["tiny"])
    assert proc.process_single_classifier("tiny") is None  # helpful-error path
    with pytest.raises(ValueError):
        proc.process_single_classifier("", classifiers["tiny"])


def test_processor_rejects_bare_classifier(data_folder, classifiers, tmp_path):
    proc = ClassifierProcessor(data_folder, transform_depth=1, top_classes=3, results_folder=tmp_path / "r3",
                               log_info=False, **CPU)
    with pytest.raises(ValueError):
        proc.process_classifiers(classifiers["tiny"])  # bare dict, not dict-of-dicts
    with pytest.raises(ValueError):
        proc.process_classifiers({})
    for bad in (dict(compare="nope"), dict(compare="reconstruction", codec_wavelet="haar", codec_color="rct"),
                dict(compare="reconstruction", codec_wavelet="legall5.3", codec_color="ict"), dict(top_classes=0)):
        with pytest.raises(ValueError):
            ClassifierProcessor(data_folder, results_folder=tmp_path / "bad", log_info=False, **CPU, **bad)


def test_registry_accepts_external_callable_model():
    class FakeKerasModel:
        def __call__(self, batch):
            return np.tile(np.arange(1000, dtype=np.float32), (len(batch), 1))

    clf = load_single_model(FakeKerasModel, shape=(32, 32), **CPU)
    logits = clf[MODEL](np.zeros((2, 32, 32, 3), np.float32))
    assert logits.shape == (2, 1000)
    decoded = clf[DEC_PRED](logits, top=3)
    assert len(decoded) == 2 and len(decoded[0]) == 3


def test_timeout_partial_results(data_folder, classifiers, tmp_path):
    kw = dict(transform_depth=1, top_classes=3, log_info=False, **CPU)
    # timeout=0 is falsy -> no deadline
    assert "tiny" in ClassifierProcessor(data_folder, results_folder=tmp_path / "t", **kw).process_classifiers(
        classifiers, timeout=0)
    # an expired deadline degrades gracefully to (possibly empty) partials
    out = ClassifierProcessor(data_folder, results_folder=tmp_path / "t2", **kw).process_classifiers(
        classifiers, timeout=1e-9)
    assert isinstance(out, dict)


def test_classifier_fault_isolation(data_folder, classifiers, tmp_path):
    """One raising classifier must not stop the others."""

    class ExplodingModel:
        def __call__(self, batch):
            raise RuntimeError("boom")

    bad = load_single_model(ExplodingModel, shape=(32, 32), **CPU)
    proc = ClassifierProcessor(data_folder, transform_depth=1, top_classes=3, results_folder=tmp_path / "f",
                               log_info=False, **CPU)
    out = proc.process_classifiers({"bad": bad, "tiny": classifiers["tiny"]})
    assert "tiny" in out and "bad" not in out
    base = tmp_path / "f" / "depth-1"
    assert (base / "tiny-summary-depth-1.csv").is_file() and not (base / "bad-summary-depth-1.csv").exists()


def test_hung_classifier_times_out(data_folder, classifiers, tmp_path):
    """The timeout bounds even a hung model call: partial results come back
    instead of a blocked run."""

    class HungModel:
        def __call__(self, batch):
            time.sleep(4.0)
            return np.zeros((len(batch), 1000), np.float32)

    slow = load_single_model(HungModel, shape=(32, 32), **CPU)
    proc = ClassifierProcessor(data_folder, transform_depth=1, top_classes=3, results_folder=tmp_path / "h",
                               log_info=False, batch_size=25, **CPU)
    t0 = time.time()
    out = proc.process_classifiers({"tiny": classifiers["tiny"], "slow": slow}, timeout=2)
    assert time.time() - t0 < 10.0
    assert "tiny" in out and "slow" not in out


def test_reconstruction_compare_lossless_rct_agrees_fully(data_folder, classifiers, tmp_path):
    """The lossless 5/3 + RCT roundtrip is exact, so source and
    reconstruction predictions agree everywhere; Haar at step 1.0 agrees
    at least half the time, as in the reference's test."""
    kw = dict(transform_depth=2, top_classes=3, log_info=False, compare="reconstruction", **CPU)
    out = ClassifierProcessor(data_folder, results_folder=tmp_path / "ll", codec_wavelet="legall5.3",
                              codec_color="rct", **kw).process_classifiers(classifiers)
    assert out["tiny"][1].loc["mean", SIM_BEST_CLASS] == 100.0
    out = ClassifierProcessor(data_folder, results_folder=tmp_path / "haar", codec_spec=QuantSpec(base_step=1.0),
                              **kw).process_classifiers(classifiers)
    assert out["tiny"][1].loc["mean", SIM_BEST_CLASS] >= 50.0


def test_icon_routes_equal_bit_for_bit(monkeypatch):
    """The host cascade and K1's route (its plain twin here) give the same
    icons, equal to the JAX package's host icons; the route follows the
    measured link, and WICCA_TPU_ICON_PATH forces it."""
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 256, (512, 640, 3), np.uint8), rng.integers(0, 256, (97, 129, 3), np.uint8),
              rng.integers(0, 256, (512, 640, 3), np.uint8), rng.integers(0, 256, (123, 200), np.uint8)]
    monkeypatch.setattr(transfer, "link_bandwidth", lambda probe=False, device=None: 40e6)
    assert processor._icon_route(images[0].nbytes, 0.33, "cpu") == "host"
    for depth in (1, 4, 6):
        host = processor._compute_icons_batched(images, depth, "cpu")
        monkeypatch.setenv("WICCA_TPU_ICON_PATH", "device")
        dwt_cuda.reset_launches()
        dev = processor._compute_icons_batched(images, depth, "cpu")
        monkeypatch.delenv("WICCA_TPU_ICON_PATH")
        assert dwt_cuda.LAUNCHES["icon"] == 0  # CPU tensors take the plain twin
        for h, d, im in zip(host, dev, images):
            planar = np.moveaxis(im, -1, 0) if im.ndim == 3 else im
            want = jax_icons_multi(planar, (depth,))[depth]
            want = np.moveaxis(want, 0, -1) if im.ndim == 3 else want
            np.testing.assert_array_equal(h, want)
            np.testing.assert_array_equal(d, want)
    want = np.moveaxis(jax_icons_multi(np.moveaxis(images[1], -1, 0), (3,))[3], 0, -1)
    np.testing.assert_array_equal(processor._compute_icon(images[1], 3, "cpu"), want)
    monkeypatch.setattr(transfer, "link_bandwidth", lambda probe=False, device=None: math.inf)
    assert processor._icon_route(images[0].nbytes, 0.33, "cpu") == "device"
    assert processor._roundtrip_route(images[0].nbytes, 0.33, "cpu") == "device"
    monkeypatch.setenv("WICCA_TPU_ICON_PATH", "host")
    assert processor._icon_route(images[0].nbytes, 0.33, "cpu") == "host"
    assert processor._roundtrip_route(images[0].nbytes, 0.33, "cpu") == "host"


def test_icon_host_matches_k1_and_the_jax_module():
    rng = np.random.default_rng(9)
    planar = rng.integers(0, 256, (3, 250, 318), np.uint8)
    multi = icons_multi(planar, (1, 3, 4, 6))
    want = jax_icons_multi(planar, (1, 3, 4, 6))
    for d, icon in multi.items():
        np.testing.assert_array_equal(icon, want[d])
        np.testing.assert_array_equal(icon, icon_host(planar, d))
        unit = 1 << d
        padded = np.pad(planar, [(0, 0), (0, (-250) % unit), (0, (-318) % unit)], mode="edge")
        np.testing.assert_array_equal(icon, dwt_cuda.icon_plain(torch.from_numpy(padded), d).numpy())
    with pytest.raises(TypeError):
        icon_host(planar.astype(np.uint16), 2)
    with pytest.raises(ValueError):
        icons_multi(planar, (0,))


def test_resume_skips_finished_pairs(data_folder, classifiers, tmp_path):
    kw = dict(transform_depth=(1, 2), top_classes=3, log_info=False, results_folder=tmp_path / "res", **CPU)
    first = ClassifierProcessor(data_folder, **kw).process_classifiers(classifiers)

    class MustNotRun:
        def __call__(self, batch):
            raise AssertionError("resume ran a finished classifier")

    again = ClassifierProcessor(data_folder, resume=True, **kw).process_classifiers(
        {"tiny": load_single_model(MustNotRun, shape=(32, 32), **CPU)})
    pd.testing.assert_frame_equal(again["tiny"][1], first["tiny"][1], check_names=False)


def test_classifier_workers_policy():
    """The reference's `parallel`: one thread per classifier unless capped,
    on the card and on the CPU alike."""
    proc = ClassifierProcessor.__new__(ClassifierProcessor)
    proc.parallel = None
    assert proc._classifier_workers(4) == 4
    proc.parallel = 2
    assert proc._classifier_workers(4) == 2
    assert proc._classifier_workers(1) == 1


def _barrier_classifier(barrier, shape=(32, 32)):
    """A fake classifier whose model() blocks on a shared barrier: only
    concurrent classifier execution lets it proceed."""

    def model(x):
        barrier.wait(timeout=20)
        return np.tile(np.arange(10, dtype=np.float32), (len(x), 1))

    def dec(logits, top=5):
        order = np.argsort(-np.asarray(logits), axis=1)[:, :top]
        return [[(f"n{j}", f"class_{j}", 1.0) for j in row] for row in order]

    return {MODEL: model, PRE_INP: lambda x: x / 255.0, DEC_PRED: dec, SHAPE: shape}


def test_classifiers_fan_out_concurrently(data_folder, tmp_path):
    """Two barrier classifiers deadlock unless both batches run at once."""
    barrier = threading.Barrier(2)
    clfs = {"a": _barrier_classifier(barrier), "b": _barrier_classifier(barrier)}
    proc = ClassifierProcessor(data_folder, transform_depth=1, results_folder=tmp_path / "r", log_info=False,
                               batch_size=100, top_classes=3, **CPU)
    assert set(proc.process_classifiers(clfs, timeout=60)) == {"a", "b"}


def test_classifiers_serialize_with_parallel_1(data_folder, classifiers, tmp_path):
    """parallel=1 pins the classifier pool to one thread: the barrier
    classifier fails in isolation and the other one's results persist."""
    barrier = threading.Barrier(2)

    def fast_fail_wait(timeout=None):
        raise threading.BrokenBarrierError()

    barrier.wait = fast_fail_wait
    clfs = {"a": _barrier_classifier(barrier), "ok": classifiers["tiny"]}
    proc = ClassifierProcessor(data_folder, transform_depth=1, results_folder=tmp_path / "r1", log_info=False,
                               batch_size=100, parallel=1, top_classes=3, **CPU)
    res = proc.process_classifiers(clfs, timeout=60)
    assert "ok" in res and "a" not in res


class _CountingCoder:
    """A custom coder (``get_small_copy``: a strided subsample) that counts
    the icons it has made, for classifiers that wait on that count."""

    def __init__(self):
        self.made = 0
        self.cond = threading.Condition()

    def get_small_copy(self, image, depth):
        icon = np.ascontiguousarray(image[:: 1 << depth, :: 1 << depth])
        with self.cond:
            self.made += 1
            self.cond.notify_all()
        return icon

    def wait_for(self, n, timeout=10.0):
        with self.cond:
            return self.cond.wait_for(lambda: self.made >= n, timeout)


class _GatedModel:
    """The deterministic model, keeping every batch it is fed; with a coder,
    each call for batch b first waits until the coder has made batch b+1's
    icons (``overlapped`` records whether it came); it raises at call
    ``raise_at``."""

    def __init__(self, model, coder=None, batch_size=2, n_images=6, raise_at=None):
        self.model, self.coder, self.batch_size, self.n_images = model, coder, batch_size, n_images
        self.raise_at = raise_at
        self.fed: list[np.ndarray] = []
        self.overlapped: list[bool] = []

    def __call__(self, batch):
        call = len(self.fed)
        self.fed.append(np.array(batch))
        if self.coder is not None:
            batch_index = call // 2  # a batch is fed twice: its sources, then its icons
            self.overlapped.append(self.coder.wait_for(min(self.batch_size * (batch_index + 2), self.n_images)))
        if call == self.raise_at:
            raise RuntimeError("boom")
        return self.model(batch)


def _gated(coder=None, raise_at=None):
    clf = deterministic_classifier(decode_predictions)
    clf[MODEL] = _GatedModel(clf[MODEL], coder, raise_at=raise_at)
    return clf


def test_batches_classify_under_the_next_batchs_icons(data_folder, tmp_path):
    """Batch n's classification finishes only after the main thread has made
    batch n+1's icons, and the rows, their order and the batches fed equal
    the JAX harness's, which runs one batch at a time."""
    common = dict(transform_depth=2, interpolation=3, top_classes=5, log_info=False, batch_size=2)
    jax_clf = deterministic_classifier(jax_decode)
    jax_clf[MODEL] = _GatedModel(jax_clf[MODEL])
    JaxProcessor(data_folder, results_folder=tmp_path / "jax", wavelet_coder=_CountingCoder(),
                 **common).process_classifiers({"det": jax_clf})
    coder = _CountingCoder()
    port_clf = _gated(coder)
    ClassifierProcessor(data_folder, results_folder=tmp_path / "port", wavelet_coder=coder, **common,
                        **CPU).process_classifiers({"det": port_clf}, timeout=60)
    assert port_clf[MODEL].overlapped == [True] * 6
    assert len(port_clf[MODEL].fed) == len(jax_clf[MODEL].fed) == 6
    for port_batch, jax_batch in zip(port_clf[MODEL].fed, jax_clf[MODEL].fed):
        np.testing.assert_array_equal(port_batch, jax_batch)
    for suffix in ("det-depth-2.csv", "det-summary-depth-2.csv"):
        assert (tmp_path / "port" / "depth-2" / suffix).read_bytes() == (
            tmp_path / "jax" / "depth-2" / suffix).read_bytes()


def test_a_classifier_raising_with_the_next_batch_ready(data_folder, tmp_path, caplog):
    """A classifier that raises in batch 2 of 3, once batch 3's icons are
    made: one warning, no results of its own and no batch 3 fed to it; the
    other classifier's CSVs are those of a run without it."""
    common = dict(transform_depth=1, top_classes=3, log_info=False, batch_size=2, **CPU)
    coder = _CountingCoder()
    flaky = _gated(coder, raise_at=2)  # batch 2's sources
    with caplog.at_level(logging.WARNING):
        out = ClassifierProcessor(data_folder, results_folder=tmp_path / "both", wavelet_coder=coder,
                                  **common).process_classifiers({"flaky": flaky, "det": _gated()}, timeout=60)
    assert set(out) == {"det"}
    assert sum("'flaky'" in r.getMessage() for r in caplog.records) == 1
    assert flaky[MODEL].overlapped == [True] * 3 and len(flaky[MODEL].fed) == 3
    ClassifierProcessor(data_folder, results_folder=tmp_path / "alone", wavelet_coder=_CountingCoder(),
                        **common).process_classifiers({"det": _gated()})
    both, alone = tmp_path / "both" / "depth-1", tmp_path / "alone" / "depth-1"
    assert not (both / "flaky-depth-1.csv").exists()
    assert len(pd.read_csv(both / "det-depth-1.csv")) == 6
    for suffix in ("det-depth-1.csv", "det-summary-depth-1.csv"):
        assert (both / suffix).read_bytes() == (alone / suffix).read_bytes()


def test_hung_classifier_with_a_batch_in_flight_returns_by_the_deadline(data_folder, classifiers, tmp_path):
    """A model that hangs on batch 1 while batch 2 is decoded and iconed:
    the call returns at its deadline with the other classifier's rows, and
    the hung one is fed nothing more."""
    release = threading.Event()
    fed = []

    class HungModel:
        def __call__(self, batch):
            fed.append(len(batch))
            release.wait(60)
            return np.zeros((len(batch), 1000), np.float32)

    hung = load_single_model(HungModel, shape=(32, 32), **CPU)
    proc = ClassifierProcessor(data_folder, transform_depth=1, top_classes=3, results_folder=tmp_path / "h",
                               log_info=False, batch_size=2, **CPU)
    try:
        t0 = time.time()
        out = proc.process_classifiers({"tiny": classifiers["tiny"], "hung": hung}, timeout=2)
        elapsed = time.time() - t0
    finally:
        release.set()
    assert elapsed < 4.0
    assert "tiny" in out and "hung" not in out
    assert fed == [2]


def test_the_harness_needs_a_card_or_device_cpu(data_folder, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClassifierProcessor(data_folder, results_folder=tmp_path / "r", log_info=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_models({"tiny": ("SimpleCNN", {"shape": (32, 32)})})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_single_model("NoSuchNet")  # the device rule comes before the name lookup


# ---- the results layer's quirks (tests/test_quirks.py on the port) ----


def _write_summary(folder, name, depth, base=1.0):
    res = pd.DataFrame({"file": ["a.png", "b.png"], SIM_CLASSES: [base, base + 1],
                        SIM_CLASSES_PERC: [base * 10, base * 20], SIM_BEST_CLASS: [100.0, 0.0]})
    save_results(folder, depth, name, res, summarize(res))


@pytest.fixture()
def results_folder(tmp_path):
    folder = tmp_path / "results"
    folder.mkdir()
    _write_summary(folder, "m", 3, base=3.0)
    _write_summary(folder, "m", 1, base=1.0)
    return folder


def test_bad_depth_coerced_to_3(results_folder, caplog):
    with caplog.at_level(logging.WARNING):
        df = load_summary_results(results_folder, "m", depth="five")
    assert float(df.set_index(df.columns[0]).loc["mean", SIM_CLASSES]) == 3.5
    assert any("depth" in r.message.lower() for r in caplog.records)
    assert load_summary_results(results_folder, "m", depth=True) is not None


def test_non_str_classifier_name_logged_but_continues(results_folder, caplog):
    with caplog.at_level(logging.ERROR):
        assert load_summary_results(results_folder, 123, 3) is None
    assert any(r.levelno >= logging.ERROR for r in caplog.records)


def test_non_bool_describe_treated_as_false(results_folder, capsys):
    assert load_summary_results(results_folder, "m", 3, describe="yes") is not None
    assert "columns:" not in capsys.readouterr().out
    load_summary_results(results_folder, "m", 3, describe=True)
    assert "columns:" in capsys.readouterr().out


def test_compare_summaries_quirks(results_folder, caplog):
    comp = compare_summaries(results_folder, {"m": {"model": object()}}, (1, 3))  # a dict iterates its keys
    assert comp["Classifier"].tolist() == ["m", "m"] and comp["Depth"].tolist() == [1, 3]
    with caplog.at_level(logging.WARNING):
        comp = compare_summaries(results_folder, ["m"], 3, target_stat=42)
    assert float(comp[SIM_CLASSES].iloc[0]) == 3.5  # the mean row
    assert compare_summaries(results_folder, ["m"], 3, target_stat="median").empty
    assert load_summary_results(results_folder, "ghost", 3) is None
    with pytest.raises(ValueError):
        extract_from_comparison(comp, "no such metric")


def test_summary_csvs_equal_the_jax_results_layer(results_folder, tmp_path):
    from wicca_tpu.analysis.results import save_results as jax_save
    from wicca_tpu.analysis.results import summarize as jax_summarize

    res = pd.DataFrame({"file": ["a.png", "b.png", "c.png"], SIM_CLASSES: [1, 3, 5],
                        SIM_CLASSES_PERC: [20.0, 60.0, 100.0], SIM_BEST_CLASS: [100.0, 0.0, 100.0]})
    res.index.name = "index"
    a = jax_save(tmp_path / "j", 2, "x", res, jax_summarize(res))
    b = save_results(tmp_path / "p", 2, "x", res, summarize(res))
    assert a.regular.read_bytes() == b.regular.read_bytes() and a.summary.read_bytes() == b.summary.read_bytes()


@pytest.mark.parametrize("bad", [0, -1, 1.5, "3", True, False, None, [1, 0], (1, "2"), [True]])
def test_normalize_depth_contract(bad):
    from wicca_tpu_torch.data.normalization import normalize_depth

    assert normalize_depth(4) == (4,) and normalize_depth([1, 2]) == (1, 2)
    assert normalize_depth((5,)) == (5,) and normalize_depth(range(1, 4)) == (1, 2, 3)
    with pytest.raises(ValueError):
        normalize_depth(bad)


def test_normalize_folder_contract(tmp_path):
    from pathlib import Path

    from wicca_tpu_torch.data.normalization import normalize_folder

    assert normalize_folder(str(tmp_path)) == Path(str(tmp_path)) and normalize_folder(tmp_path) == tmp_path
    with pytest.raises(TypeError):
        normalize_folder(123)


def test_later_depths_overwrite_results_dict(data_folder, classifiers, tmp_path):
    """process_classifiers returns the last depth's summary per classifier;
    earlier depths survive as CSVs."""
    proc = ClassifierProcessor(data_folder, transform_depth=(1, 3), results_folder=tmp_path / "res",
                               log_info=False, **CPU)
    _, sum_df = proc.process_classifiers(classifiers)["tiny"]
    on_disk = pd.read_csv(tmp_path / "res" / "depth-3" / "tiny-summary-depth-3.csv", index_col=0)
    pd.testing.assert_frame_equal(sum_df, on_disk, check_names=False)


# ---- small shared pieces ----


def test_decode_predictions_equals_the_jax_package():
    rng = np.random.default_rng(3)
    preds = rng.standard_normal((4, 1000)).astype(np.float32)
    preds[1, 10:30] = 5.0  # ties keep np.argsort(row)[::-1] order
    assert decode_predictions(preds, top=7) == jax_decode(preds, top=7)
    with pytest.raises(ValueError):
        decode_predictions(preds[0])


@pytest.mark.parametrize("seconds", [0, 0.4, 59, 61, 3600, 3725.6])
def test_format_proc_time_equals_the_jax_package(seconds):
    assert format_proc_time(seconds) == jax_format_proc_time(seconds)


def test_stage_timer_and_trace(tmp_path):
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("a"):
            time.sleep(0.01)
    assert set(timer.totals()) == {"a"} and timer.totals()["a"] >= 0.02 and "x2" in timer.report()
    with trace(tmp_path / "trace"):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").is_file()
