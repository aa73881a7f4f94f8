"""ClassifierProcessor, the comparison engine (counterpart of
``wicca_tpu/harness/processor.py``): every image of a folder and its icon
(or its codec reconstruction) through each classifier, per transform depth,
into the reference-layout CSVs and ``run-metrics.json``.

* Icons are computed once per (image, depth) and shared by every
  classifier. They run on ``device``: the icon kernel K1
  (:func:`wicca_tpu_torch.ops.dwt_cuda.icon`) on CUDA, one launch per group
  of same-bucket images (up to 512 MB a launch), or its plain twin for
  ``device='cpu'``; or on the host (:mod:`wicca_tpu_torch.core.icon_host`,
  bit-exact) where the measured link makes the upload cost more.
* Images go up as decoded and are made planar and replicate-padded to a
  512 bucket on the device; Haar tile locality keeps the cropped icons
  bit-exact.
* ``compare='reconstruction'`` runs the codec roundtrip (K2/K3 for Haar,
  K6/K7 for ``legall5.3``, K8/K9 for a float wavelet), or the host route
  where it is priced lower.
* Resizes stay on host cv2 with the caller's interpolation, as the
  reference does; classifiers fan out over threads (the reference's
  ``parallel``) and run one batch behind the main thread, which decodes
  and icons the next batch meanwhile.

The constructor signature and the CSV layout are the reference's, plus
``device``: CUDA unless the caller passes ``device='cpu'``; with no card and
no explicit CPU device the constructor raises.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from wicca_tpu_torch._device import host_data_device
from wicca_tpu_torch.analysis import results as rsltmgr
from wicca_tpu_torch.config.aliases import Depth
from wicca_tpu_torch.config.constants import DEC_PRED, ICON, MODEL, PRE_INP, RESULTS_FOLDER, SHAPE, SOURCE
from wicca_tpu_torch.data.loader import from_planar, iter_decoded, list_images, to_planar
from wicca_tpu_torch.data.normalization import normalize_depth
from wicca_tpu_torch.data.validation import validate_input_folder, validate_output_folder

_BUCKET = 512  # pad H/W up to multiples of this, so that frames of a dataset group into one launch
_MAX_STACK_BYTES = 512 * 1024 * 1024  # cap of one icon launch's input


def _forced_route() -> str | None:
    forced = os.environ.get("WICCA_TPU_ICON_PATH", "auto").lower()
    return forced if forced in ("host", "device") else None


def _icon_route(nbytes: int, megapixels: float, device=None) -> str:
    """Host-vs-device route of the icons, by measured rates: device cost =
    the full-resolution upload over the measured link; host cost =
    megapixels over the measured numpy icon rate. Both routes give the same
    icons bit for bit. ``WICCA_TPU_ICON_PATH`` forces host|device."""
    forced = _forced_route()
    if forced:
        return forced
    from wicca_tpu_torch.codec import transfer
    from wicca_tpu_torch.core import icon_host

    link = transfer.link_bandwidth(probe=True, device=device)
    if link is None or link != link or link == float("inf"):
        return "device"
    device_s = nbytes / link + 0.002
    host_s = megapixels / icon_host.measured_mp_per_s()
    return "host" if host_s < device_s else "device"


def _roundtrip_route(nbytes: int, megapixels: float, device=None) -> str:
    """Route of the codec roundtrip (``compare='reconstruction'``): the
    device pays both link directions, the host its encode and decode
    cascades at their measured rates. Bit-identical either way;
    ``WICCA_TPU_ICON_PATH`` forces host|device."""
    forced = _forced_route()
    if forced:
        return forced
    from wicca_tpu_torch.codec import host_decode, host_encode, transfer

    link = transfer.link_bandwidth(probe=True, device=device)
    if link is None or link != link or link == float("inf"):
        return "device"
    device_s = 2.0 * nbytes / link + 0.004
    host_s = megapixels / host_encode.measured_mp_per_s() + megapixels / host_decode.measured_mp_per_s("haar")
    return "host" if host_s < device_s else "device"


def _compute_icons_batched(images_hwc: list[np.ndarray], depth: int, device=None) -> list[np.ndarray]:
    """Depth-d icons of HWC uint8 images (bit-exact against the reference
    HaarCoder), one K1 launch per group of same-bucket images and stack
    chunk on ``device`` (its plain twin for a CPU device), or the host
    cascade where the route model prices it lower (:func:`_icon_route`).

    Each image crosses to the card as it was decoded (HWC, through pinned
    memory); the planar layout, the bucket padding and the stack are made
    there, so the host copies nothing but the upload. Bucket padding
    (replicate) only adds rows/cols below/right of the alignment padding;
    every kept icon pixel's 2^d x 2^d support is identical, so cropping
    restores the exact reference icon."""
    from wicca_tpu_torch.codec import transfer
    from wicca_tpu_torch.core.pad import pad_to_multiple
    from wicca_tpu_torch.ops import dwt_cuda

    dev = host_data_device(device)
    unit = 1 << depth
    total_bytes = sum(im.nbytes for im in images_hwc)
    total_mp = sum(im.shape[0] * im.shape[1] for im in images_hwc) / 1e6
    if all(im.dtype == np.uint8 for im in images_hwc) and _icon_route(total_bytes, total_mp, dev) == "host":
        from wicca_tpu_torch.core.icon_host import icon_host

        return [from_planar(icon_host(to_planar(im), depth)) for im in images_hwc]
    bucket = max(_BUCKET, unit)
    groups: dict[tuple[int, int, int], list[int]] = {}
    for idx, img in enumerate(images_hwc):
        h, w = img.shape[:2]
        planes = 1 if img.ndim == 2 else img.shape[2]
        groups.setdefault((planes, -(-h // bucket) * bucket, -(-w // bucket) * bucket), []).append(idx)

    def planar(img: np.ndarray) -> torch.Tensor:
        x = transfer.put_array(img, dev) if dev.type == "cuda" else torch.from_numpy(img)
        return pad_to_multiple(to_planar(x), bucket, mode="replicate")

    icons: list[np.ndarray | None] = [None] * len(images_hwc)
    for shape, idxs in groups.items():
        chunk = max(1, _MAX_STACK_BYTES // int(np.prod(shape)))
        for start in range(0, len(idxs), chunk):
            part = idxs[start : start + chunk]
            out = dwt_cuda.icon(torch.stack([planar(images_hwc[i]) for i in part]), depth).cpu().numpy()
            for j, idx in enumerate(part):
                h, w = images_hwc[idx].shape[:2]
                icons[idx] = from_planar(out[j][..., : -(-h // unit), : -(-w // unit)])
    return icons  # type: ignore[return-value]


def _compute_icon(image_hwc: np.ndarray, depth: int, device=None) -> np.ndarray:
    """Depth-d icon of one HWC uint8 image (see :func:`_compute_icons_batched`)."""
    return _compute_icons_batched([image_hwc], depth, device)[0]


def _resize(image_hwc: np.ndarray, shape: tuple[int, int], interpolation) -> np.ndarray:
    import cv2

    return cv2.resize(image_hwc, shape, interpolation=interpolation)


class ClassifierProcessor:
    """Drop-in equivalent of the reference ClassifierProcessor: same
    constructor arguments, same result CSVs, plus ``device``."""

    def __init__(
        self,
        data_folder: str | Path,
        wavelet_coder: Any = None,
        transform_depth: Depth = 3,
        interpolation: int = 3,  # cv2.INTER_AREA
        top_classes: int = 5,
        results_folder: str | Path = RESULTS_FOLDER,
        log_info: bool = True,
        parallel: int | None = None,
        batch_size: int = 25,
        overwrite: bool = True,
        resume: bool = False,
        compare: str = "icon",
        codec_spec=None,
        codec_wavelet: str = "haar",
        codec_color: str = "none",
        device=None,
    ):
        self.device = host_data_device(device)
        self.path = validate_input_folder(data_folder)
        self.coder = wavelet_coder  # optional custom coder: get_small_copy(img, depth)
        self.depth: Any = normalize_depth(transform_depth)
        if not (isinstance(top_classes, int) and top_classes > 0):
            msg = f"top_classes wants an int >= 1, got {top_classes!r}"
            logging.error(msg)
            raise ValueError(msg)
        self.top = top_classes
        self.interpolation = interpolation
        self.results_folder = validate_output_folder(results_folder, overwrite=overwrite)
        # the reference's `parallel`: classifier threads (one card runs the
        # threads' streams concurrently); also the width of the decode pool
        self.parallel = parallel
        self.batch_size = batch_size
        # resume: skip (classifier, depth) pairs whose summary CSV exists
        self.resume = resume
        # compare="icon": source vs LL icon (the reference). "reconstruction":
        # source vs the quantized codec roundtrip at the depth (codec_spec
        # defaults to QuantSpec())
        if compare not in ("icon", "reconstruction"):
            raise ValueError("compare must be 'icon' or 'reconstruction'")
        self.compare = compare
        self.codec_spec = codec_spec
        if compare == "reconstruction":
            from wicca_tpu_torch.core.lifting import is_integer_wavelet

            if codec_color == "rct" and not is_integer_wavelet(codec_wavelet):
                raise ValueError("codec_color='rct' needs an integer wavelet (legall5.3)")
            if codec_color == "ict" and is_integer_wavelet(codec_wavelet):
                raise ValueError("codec_color='ict' needs a float wavelet")
        self.codec_wavelet = codec_wavelet
        self.codec_color = codec_color
        if log_info:
            self._log_init_info()

    # -- info -------------------------------------------------------------

    def _log_init_info(self) -> None:
        """Dataset summary: image count, mean size of up to
        MAX_INFO_SAMPLE_SIZE images, depths, output folder (Markdown inside
        Jupyter)."""
        from wicca_tpu_torch.config.constants import MAX_INFO_SAMPLE_SIZE
        from wicca_tpu_torch.utils.env import is_jupyter

        files = list_images(self.path)
        lines = [f"Dataset folder: {self.path}", f"Images found: {len(files)}"]
        dims = []
        for f in files[:MAX_INFO_SAMPLE_SIZE]:
            try:
                import cv2

                img = cv2.imread(str(f))
                if img is not None:
                    dims.append(img.shape[:2])
            except ImportError:
                break
        if dims:
            mh = sum(d[0] for d in dims) / len(dims)
            mw = sum(d[1] for d in dims) / len(dims)
            lines.append(f"Mean image dimensions (n={len(dims)}): {mw:.0f}x{mh:.0f}")
            lines.append(f"Mean image resolution: {mh * mw / 1e6:.1f} MP")
        lines.append(f"Transform depths: {self.depth}")
        lines.append(f"Writing results to: {self.results_folder}")
        if is_jupyter():
            try:
                from IPython.display import Markdown, display  # type: ignore

                display(Markdown("**Dataset info**  \n" + "  \n".join(lines)))
                return
            except ImportError:
                pass
        print("\n".join(lines))

    # -- core -------------------------------------------------------------

    def _reconstruction(self, image_hwc: np.ndarray, depth: int) -> np.ndarray:
        """Full-resolution quantized codec roundtrip (compare='reconstruction'),
        on the host route or on ``device``. There the frame goes up as decoded
        (HWC, through pinned memory), its planar layout is made on the device,
        and the reconstruction comes back HWC."""
        from wicca_tpu_torch.codec import host_decode, host_encode, transfer
        from wicca_tpu_torch.codec.pipeline import decode, encode
        from wicca_tpu_torch.core.quant import QuantSpec

        spec = self.codec_spec or QuantSpec()
        h, w = image_hwc.shape[:2]
        color = self.codec_color if image_hwc.ndim == 3 and image_hwc.shape[2] == 3 else "none"
        if (
            host_encode.supported_encode(image_hwc, self.codec_wavelet, color, 8)
            and _roundtrip_route(image_hwc.nbytes, h * w / 1e6, self.device) == "host"
        ):
            stream = host_encode.host_encode(to_planar(image_hwc), levels=depth, spec=spec)
            return from_planar(host_decode.host_decode(stream).numpy())
        x = transfer.put_array(image_hwc, self.device) if self.device.type == "cuda" else torch.from_numpy(image_hwc)
        stream = encode(to_planar(x), levels=depth, spec=spec, wavelet=self.codec_wavelet, color=color)
        return transfer.fetch_array_parallel(from_planar(decode(stream, emit_u8=True)).contiguous())

    def _classifier_workers(self, n_classifiers: int) -> int:
        """Classifier-level thread fan-out width, the reference's
        ``ThreadPoolExecutor(max_workers=parallel)``: min(parallel or n, n)
        (the JAX package's non-TPU rule; on a card the threads' CUDA streams
        run concurrently)."""
        return max(1, min(self.parallel or n_classifiers, n_classifiers))

    def _classify_depth(
        self, classifiers: dict[str, dict], depth: int, deadline: float | None
    ) -> dict[str, tuple[str, Any]]:
        """One depth: stream images, icon once each, run every classifier on
        the shared batch.

        A one-batch pipeline: while the classifiers run batch n, the main
        thread takes batch n+1 from the decode pool and makes its icons;
        then it collects batch n and only then submits batch n+1. At most
        one batch is in the classifiers, and batches enter each classifier
        and its rows enter the results in the folder's order. Each batch
        owns its file and image lists, so no worker sees them change.

        Fault isolation and timeout: each classifier's resize, preprocess
        and inference run in a worker thread; an exception disables that
        classifier from the next batch on (logged; the others go on), and
        ``deadline`` bounds even a hung model call through
        ``future.result(timeout=...)``: the call is abandoned (its thread
        finishes in the background) and partial results persist, each batch
        a classifier had finished by then among them.

        Counters (under a profiler session, :mod:`wicca_tpu_torch.utils.timing`):
        ``harness.batches`` once per batch collected, and
        ``harness.classify_hidden`` where every classifier had finished that
        batch before the main thread came to wait on it.
        """
        from concurrent.futures import ThreadPoolExecutor
        from concurrent.futures import TimeoutError as FutureTimeout

        from wicca_tpu_torch.utils.timing import StageTimer, count

        files = list_images(self.path)
        shapes = {name: clf[SHAPE] for name, clf in classifiers.items()}
        # accumulated decoded predictions per classifier per file
        preds: dict[str, dict[str, dict]] = {name: {} for name in classifiers}
        failed: set[str] = set()
        timed_out = False

        timer = StageTimer()
        pool = ThreadPoolExecutor(max_workers=self._classifier_workers(len(classifiers)),
                                  thread_name_prefix="wicca-classify")

        def run_classifier(clf: dict, shape, batch: list[np.ndarray], icons: list[np.ndarray]):
            """Resize + preprocess + infer + decode for one classifier over one
            batch (worker thread; returns {kind: decoded_rows})."""
            model, pre, dec = clf[MODEL], clf[PRE_INP], clf[DEC_PRED]
            rows: dict[str, list] = {}
            for kind, sources in ((SOURCE, batch), (ICON, icons)):
                with timer.stage("resize"):
                    stack = np.stack([_resize(im, shape, self.interpolation) for im in sources])
                with timer.stage("inference"):
                    logits = model(np.asarray(pre(stack), dtype=np.float32))
                rows[kind] = dec(logits, top=self.top)
            return rows

        def make_icons(images: list[np.ndarray], index: int) -> list[np.ndarray]:
            with timer.stage("icon_dwt", index):
                if self.compare == "reconstruction":
                    return [self._reconstruction(img, depth) for img in images]
                if self.coder is not None and hasattr(self.coder, "get_small_copy"):
                    return [self.coder.get_small_copy(img, depth) for img in images]
                return _compute_icons_batched(images, depth, self.device)

        def submit(index: int, names: list[str], images: list[np.ndarray], icons: list[np.ndarray]):
            """Queues the batch on every classifier that has not failed; the
            batch's record for :func:`collect`."""
            futures: dict[str, Any] = {}
            if not timed_out:
                for name, clf in classifiers.items():
                    if name not in failed:
                        futures[name] = pool.submit(run_classifier, clf, shapes[name], images, icons)
            return index, names, futures

        def collect(record) -> None:
            """Waits on the batch's futures in the classifiers' order and
            keeps their rows."""
            nonlocal timed_out
            index, names, futures = record
            if not futures:
                return
            count("harness.batches", 1)
            if all(future.done() for future in futures.values()):
                count("harness.classify_hidden", 1)
            for name, future in futures.items():
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    timed_out = True
                try:
                    if timed_out and not future.done():
                        raise FutureTimeout()
                    with timer.stage("wait_classifiers", index):
                        rows = future.result(timeout=remaining)
                except FutureTimeout:
                    if not future.cancel():  # running or done: abandon it
                        logging.warning(
                            f"Classifier '{name}' exceeded the timeout at depth {depth}; "
                            "abandoning the call and returning partial results"
                        )
                    timed_out = True
                    continue
                except Exception as exc:  # noqa: BLE001 — isolate one bad classifier
                    logging.warning(
                        f"Classifier '{name}' raised at depth {depth} ({exc!r}); "
                        "continuing with the remaining classifiers"
                    )
                    failed.add(name)
                    continue
                for kind, decoded_rows in rows.items():
                    for fname, row in zip(names, decoded_rows):
                        preds[name].setdefault(fname, {})[kind] = [row]

        batches = 0  # made so far: the per-batch spans' argument
        in_flight = None  # the record of the batch in the classifiers

        def advance(names: list[str], images: list[np.ndarray]) -> None:
            """Icons of a full batch under the classification of the one
            before, then that one collected and this one submitted."""
            nonlocal batches, in_flight
            batches += 1
            icons = make_icons(images, batches)
            if in_flight is not None:
                collect(in_flight)
            in_flight = submit(batches, names, images, icons)

        n_pixels = 0
        t_start = time.time()
        batch_files: list[str] = []
        batch_images: list[np.ndarray] = []
        decoded = iter_decoded(files, num_threads=self.parallel or 8)
        while not timed_out:
            with timer.stage("decode"):
                try:
                    path, image = next(decoded)
                except StopIteration:
                    break
            if deadline is not None and time.time() > deadline:
                logging.warning("Processing timed out; returning partial results")
                timed_out = True
                break
            if image is None:
                logging.warning(f"Skipping unreadable file {path.name}")
                continue
            n_pixels += image.shape[0] * image.shape[1]
            batch_files.append(path.name)
            batch_images.append(image)
            if len(batch_files) >= self.batch_size:
                advance(batch_files, batch_images)
                batch_files, batch_images = [], []
        if batch_files and not timed_out:
            advance(batch_files, batch_images)
        if in_flight is not None:
            collect(in_flight)
        # a timed-out worker may still be running a hung model call; don't wait
        pool.shutdown(wait=False)

        out: dict[str, tuple[str, Any]] = {}
        with timer.stage("results"):
            for name in classifiers:
                if name in failed or not preds[name]:
                    continue
                res_df = rsltmgr.get_short_comparison(preds[name], self.top)
                res_df.index.name = "index"
                sum_df = rsltmgr.summarize(res_df)
                rsltmgr.save_results(self.results_folder, depth, name, res_df, sum_df)
                out[name] = (name, sum_df)
        self._write_run_metrics(depth, timer, n_pixels, time.time() - t_start, list(classifiers))
        return out

    def _write_run_metrics(self, depth: int, timer, n_pixels: int, wall_s: float, names: list[str]) -> None:
        """Structured per-run metrics (``depth-{d}/run-metrics.json``)."""
        metrics = {
            "depth": depth,
            "classifiers": names,
            "images_pixels": n_pixels,
            "wall_s": round(wall_s, 3),
            "megapixels_per_s": round(n_pixels / 1e6 / max(wall_s, 1e-9), 3),
            "stage_seconds": {k: round(v, 3) for k, v in timer.totals().items()},
        }
        path = Path(self.results_folder) / f"depth-{depth}" / "run-metrics.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(metrics, indent=2))

    # -- public API -----------------------------------------------------------

    def process_classifiers(self, classifiers: dict[str, Any], timeout: int | None = None):
        """Depth sweep over all classifiers. Returns {name: (name, summary_df)}
        for the last depth, like the reference (later depths overwrite
        earlier ones; every depth's results persist as CSVs)."""
        if not isinstance(classifiers, dict) or not classifiers:
            raise ValueError("classifiers must be a non-empty dict of name -> classifier dict")
        first = next(iter(classifiers.values()))
        if not (isinstance(first, dict) and MODEL in first):
            raise ValueError(
                "Expected a dict of classifiers (name -> {model,...}); did you pass a bare classifier dict?"
            )
        deadline = time.time() + timeout if timeout else None
        depths = self.depth if isinstance(self.depth, tuple) else (self.depth,)
        results: dict[str, tuple[str, Any]] = {}
        for depth in depths:
            todo = dict(classifiers)
            if self.resume:
                for name in list(todo):
                    paths = rsltmgr.result_paths(self.results_folder, depth, name)
                    if paths.summary.is_file():
                        logging.info(f"resume: skipping {name} depth {depth} (summary exists)")
                        import pandas as pd

                        results[name] = (name, pd.read_csv(paths.summary, index_col=0))
                        del todo[name]
            if not todo:
                continue
            t0 = time.time()
            results.update(self._classify_depth(todo, depth, deadline))
            logging.info(f"Depth {depth} done in {time.time() - t0:.1f}s")
        return results

    def _single_classifier(self, name: str, classifier_dict: dict[str, Any], timeout: int | None = None):
        if not name:
            raise ValueError("single-classifier runs need a non-empty name")
        if not isinstance(classifier_dict, dict) or MODEL not in classifier_dict:
            raise ValueError(f"the classifier spec for {name!r} has to be a dict with a {MODEL!r} entry")
        return self.process_classifiers({name: classifier_dict}, timeout)

    def process_single_classifier(self, *args, **kwargs):
        """Helpful-error wrapper: a missing-argument TypeError becomes a logged
        usage hint and a None return, as in the reference."""
        try:
            return self._single_classifier(*args, **kwargs)
        except TypeError as e:
            if "missing 1 required positional argument" not in str(e):
                raise
            logging.error(
                "process_single_classifier takes the classifier name AND its spec dict, "
                "e.g. proc.process_single_classifier('ResNet50', zoo['ResNet50'])"
            )
            return None
