"""Folder-level batch codec: host IO overlapped with device transforms
(counterpart of ``wicca_tpu/codec/batch.py``).

Image decoding, routing and the upload of device-routed frames run ahead
of the main thread on a pool of host threads; the main thread dispatches
each frame's encode or decode, and the fetch, entropy coding and file write
trail behind it on the pool (ctypes releases the GIL). The lookahead is
bounded, so large folders stream at O(prefetch) host memory.

Routing: each frame goes to the host route (``codec/host_encode.py``,
``codec/host_decode.py``: numpy + C++, the frame never crosses the link)
or the device route (the CUDA kernels, or their plain twins where
``device='cpu'``) by a cost model of measured rates: the link
(:func:`wicca_tpu_torch.codec.transfer.link_bandwidth`), the host routes'
own MP/s and the device route's own MP/s (its device time per frame, an EMA
that starts unmeasured and then counts as no time). ``path='host'`` or
``'device'`` forces a route; the environment variables
``WICCA_TPU_ENCODE_PATH`` and ``WICCA_TPU_DECODE_PATH`` (the reference's
names) override ``path``. Routing never changes an output: a frame goes to
the host by ``auto`` only where both routes give the same bytes
(:func:`wicca_tpu_torch.codec.host_decode.agrees_with_device`).

Device rule: ``device`` (CUDA unless the caller passes ``device='cpu'``)
is where device-routed frames run; without a card and without
``device='cpu'`` a call raises. Host-routed frames touch no device.

``encode_folder`` / ``decode_folder`` return the reference's metrics dict,
key for key.
"""

from __future__ import annotations

import concurrent.futures
import functools
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from wicca_tpu_torch._device import host_data_device
from wicca_tpu_torch.codec import host_decode, host_encode, transfer
from wicca_tpu_torch.codec.container import load as load_wct
from wicca_tpu_torch.codec.container import save as save_wct
from wicca_tpu_torch.codec.pipeline import decode, decode_at_level, encode, with_metadata
from wicca_tpu_torch.core.quant import QuantSpec
from wicca_tpu_torch.data.loader import from_planar, list_images, load_image, load_image_raw, to_planar
from wicca_tpu_torch.data.pngw import write_png
from wicca_tpu_torch.utils.ema import RateEMA

# the device route's own rate (MP/s of device time per frame), measured on
# the frames it runs; None (unmeasured) counts as no device time
_device_mps = {"encode": RateEMA(None, min_units=0.25), "decode": RateEMA(None, min_units=0.25)}
_DISPATCH_S = 0.002  # per-frame dispatch overhead of the device route


def _device_s(kind: str, mp: float) -> float:
    rate = _device_mps[kind].rate()
    return 0.0 if rate is None else mp / rate


class _DeviceTimer:
    """The device time of work dispatched between construction and
    :meth:`stop`: CUDA events on the current stream of a card, the host
    clock on the CPU (where the work runs synchronously)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.start, self.end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.t1 = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda:
            self.end.synchronize()
            return self.start.elapsed_time(self.end) / 1e3
        return self.t1 - self.t0


def _path(env: str, path: str, what: str) -> str:
    path = os.environ.get(env, path).lower()
    if path not in ("host", "device", "auto"):
        raise ValueError(f"{what} path must be host|device|auto, got {path!r}")
    return path


def _usable(link) -> bool:
    return link is not None and link == link and link != float("inf")


def _encode_route(img: np.ndarray, wavelet: str, color: str, bit_depth: int | None, keep_alpha: bool, path: str,
                  device=None) -> str:
    """Host or device for one encode (the forward twin of
    :func:`_decode_route`): device cost = the frame's upload and the codes'
    download over the measured link + the device route's measured time +
    dispatch; host cost = megapixels / the measured host rate. Both routes
    give the same stream (tests/test_torch_host_codec.py).
    ``WICCA_TPU_ENCODE_PATH`` overrides ``path``."""
    path = _path("WICCA_TPU_ENCODE_PATH", path, "encode")
    if not host_encode.supported_encode(img, wavelet, color, bit_depth, keep_alpha):
        return "device"
    if path != "auto":
        return path
    link = transfer.link_bandwidth(probe=True, device=device)
    if not _usable(link):
        return "device"
    mp = img.shape[0] * img.shape[1] / 1e6
    # up = raw planes; down = detail codes (~0.65x the plane bytes when packed)
    device_s = img.nbytes * (1.0 + (0.65 if transfer.enabled() else 1.0)) / link + _device_s("encode", mp) + _DISPATCH_S
    host_s = mp / host_encode.measured_mp_per_s()
    return "host" if host_s < device_s else "device"


def encode_folder(
    in_dir: str | Path,
    out_dir: str | Path,
    levels: int = 5,
    spec: QuantSpec = QuantSpec(),
    wavelet: str = "haar",
    color: str = "none",
    chroma_gain: float = 1.0,
    bit_depth: int | None = None,
    codec: str = "auto",
    quality_layers: int = 1,
    threads: int = 8,
    prefetch: int | None = None,
    keep_alpha: bool = False,
    resume: bool = False,
    metadata: dict[str, bytes | str] | None = None,
    ll_codec: str = "raw",
    ll_step: float = 0.125,
    path: str = "auto",
    device=None,
) -> dict:
    """Encode every image in ``in_dir`` to ``<out_dir>/<stem>.wct``.

    ``prefetch`` pool tasks (default ``max(2, threads // 2)``) load, route
    and upload frames ahead of the main thread's encode; fetch, serialize
    and write tasks trail behind it. ``keep_alpha`` codes RGBA sources as
    4-plane streams (RGB sources are unaffected); ``resume`` skips sources
    whose ``.wct`` exists; ``metadata`` attaches the same items to every
    stream (WCT8). Unreadable images are skipped (logged). ``path`` and
    ``device``: see the module docstring. Returns throughput metrics."""
    dev = host_data_device(device)
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = list_images(in_dir)
    if not paths:
        raise ValueError(f"no images in {in_dir}")
    n_resumed = 0
    if resume:
        kept = [p for p in paths if not (out_dir / (p.stem + ".wct")).is_file()]
        n_resumed = len(paths) - len(kept)
        paths = kept
    lookahead = prefetch if prefetch is not None else max(2, threads // 2)
    if (bit_depth or 8) > 8 or keep_alpha:
        loader = functools.partial(load_image_raw, keep_alpha=keep_alpha)
    else:
        loader = load_image

    def _load_and_stage(p):
        img = loader(p)
        if img is None:
            return None
        route = _encode_route(img, wavelet, color, bit_depth, keep_alpha, path, dev)
        planar = to_planar(img)
        return img.shape, img.nbytes, route, planar if route == "host" else transfer.put_array(planar, dev)

    def _save(stream, dst: str, timer, mp: float) -> int:
        host = transfer.fetch_stream(stream)  # waits on its own copy's event only
        if timer is not None:
            _device_mps["encode"].record(mp, timer.seconds())
        return save_wct(host, dst, threads, codec, quality_layers, ll_codec=ll_codec, ll_step=ll_step)

    t0 = time.perf_counter()
    n_ok, n_host, mp_total, bytes_in = 0, 0, 0.0, 0
    with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as pool:
        loads: list = []
        writes: list = []
        it = iter(paths)

        def _fill():
            for p in it:
                loads.append((p, pool.submit(_load_and_stage, p)))
                if len(loads) >= lookahead:
                    return

        _fill()
        while loads:
            src, fut = loads.pop(0)
            _fill()
            staged = fut.result()
            if staged is None:
                logging.warning(f"skipping unreadable image {src}")
                continue
            shape, nbytes, route, x = staged
            mp = shape[0] * shape[1] / 1e6
            timer = None
            if route == "host":
                # the forward cascade on the host (native/idwt.cpp): the frame
                # never crosses the link, and the .wct bytes are the same
                stream = host_encode.host_encode(x, levels=levels, spec=spec)
                n_host += 1
            else:
                timer = _DeviceTimer(x.device)
                stream = encode(x, levels=levels, spec=spec, wavelet=wavelet, color=color, chroma_gain=chroma_gain,
                                bit_depth=bit_depth)
                timer.stop()
            if metadata:
                stream = with_metadata(stream, metadata)
            writes.append(pool.submit(_save, stream, str(out_dir / (src.stem + ".wct")), timer, mp))
            n_ok += 1
            mp_total += mp
            bytes_in += nbytes
        bytes_out = sum(w.result() for w in writes)
    seconds = time.perf_counter() - t0
    return {
        "images": n_ok,
        "skipped": len(paths) - n_ok,
        "resumed": n_resumed,
        "megapixels": round(mp_total, 4),
        "seconds": round(seconds, 3),
        "mp_per_s": round(mp_total / max(seconds, 1e-9), 2),
        "bytes_in": bytes_in,
        "bytes_out": bytes_out,
        "ratio": round(bytes_in / max(bytes_out, 1), 3),
        "host_encoded": n_host,
        "device_encoded": n_ok - n_host,
    }


def _decode_route(stream, at_level: int, path: str, device=None) -> str:
    """Host or device for one (host-loaded) stream: device cost = the
    coefficient upload and the reconstruction's download over the measured
    link + the device route's measured time + dispatch; host cost =
    megapixels / the measured host rate of the stream's kind. ``auto``
    sends a stream to the host only where the two routes agree bit for bit
    (:func:`~wicca_tpu_torch.codec.host_decode.agrees_with_device`: not for
    ``ict``, nor for Haar steps whose dequantization products round; the
    reference guards ``ict`` only). ``WICCA_TPU_DECODE_PATH`` overrides
    ``path``."""
    path = _path("WICCA_TPU_DECODE_PATH", path, "decode")
    if not host_decode.supported(stream):
        return "device"
    if path != "auto":
        return path
    if not host_decode.agrees_with_device(stream):
        return "device"
    link = transfer.link_bandwidth(probe=True, device=device)
    if not _usable(link):
        return "device"
    h, w = stream.orig_shape
    nchan = int(np.prod(stream.ll.shape[:-2])) or 1
    # the device route uploads every coefficient even for a coarse preview;
    # only the reconstruction's download shrinks with at_level
    up = stream.num_bytes() * (0.65 if transfer.enabled("up") else 1.0)
    down = (h * w * nchan * (1 if stream.bit_depth <= 8 else 2)) >> (2 * at_level)
    mp = h * w / (1e6 * (1 << (2 * at_level)))
    device_s = (up + down) / link + _device_s("decode", mp) + _DISPATCH_S
    host_s = mp / host_decode.measured_mp_per_s(host_decode._rate_kind(stream))
    return "host" if host_s < device_s else "device"


def decode_folder(
    in_dir: str | Path,
    out_dir: str | Path,
    threads: int = 8,
    on_error: str = "raise",
    suffix: str = ".png",
    prefetch: int | None = None,
    at_level: int = 0,
    resume: bool = False,
    path: str = "auto",
    device=None,
) -> dict:
    """Decode every ``.wct`` in ``in_dir`` to ``<out_dir>/<stem><suffix>``
    (native dtype: uint8, or uint16 for high-bit-depth streams).

    Each file is loaded onto the host by a pool task, routed, and only a
    device-routed stream is moved up (:func:`~wicca_tpu_torch.codec.transfer.put_stream`).
    ``at_level=r`` reconstructs at 1/2**r resolution from the coarse
    subbands only (bulk previews); ``resume`` skips streams whose output
    exists. 8-bit PNGs go through the strip-parallel writer
    (:mod:`wicca_tpu_torch.data.pngw`), each write on its share of the
    cores. ``path`` and ``device``: see the module docstring."""
    import cv2

    dev = host_data_device(device)
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(in_dir.glob("*.wct"))
    if not paths:
        raise ValueError(f"no .wct files in {in_dir}")
    n_resumed = 0
    if resume:
        kept = [p for p in paths if not (out_dir / (p.stem + suffix)).is_file()]
        n_resumed = len(paths) - len(kept)
        paths = kept
    lookahead = prefetch if prefetch is not None else max(2, threads // 2)
    # writes already run `threads` wide in the pool, so each deflates on its
    # share of the cores (threads x cpu_count zlib threads would oversubscribe)
    ncpu = os.cpu_count() or 1
    write_threads = max(1, ncpu // max(1, min(threads, ncpu)))

    def _load_and_stage(p):
        # entropy decoding runs plane-parallel inside load; a device-routed
        # stream is then moved up from this pool thread, so its upload
        # overlaps the main thread's work on earlier frames
        s = load_wct(str(p), threads, None, False, on_error, device="cpu")
        route = _decode_route(s, at_level, path, dev)
        return route, s if route == "host" else transfer.put_stream(s, dev)

    def _write(rec, dst: Path, timer, mp: float) -> int:
        rec = transfer.fetch_array_parallel(rec)  # waits on its own copy's event only
        if timer is not None:
            _device_mps["decode"].record(mp, timer.seconds())
        if suffix == ".png" and rec.dtype == np.uint8:
            write_png(str(dst), rec, threads=write_threads)
            return rec.nbytes
        hwc = from_planar(rec)
        if hwc.ndim == 3:
            cv2.imwrite(str(dst), cv2.cvtColor(hwc, cv2.COLOR_RGBA2BGRA if hwc.shape[2] == 4 else cv2.COLOR_RGB2BGR))
        else:
            cv2.imwrite(str(dst), hwc)
        return hwc.nbytes

    t0 = time.perf_counter()
    mp_total, bytes_in, n, n_host = 0.0, 0, 0, 0
    with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as pool:
        loads: list = []
        writes: list = []
        it = iter(paths)

        def _fill():
            for p in it:
                loads.append((p, pool.submit(_load_and_stage, p)))
                if len(loads) >= lookahead:
                    return

        _fill()
        while loads:
            src, fut = loads.pop(0)
            _fill()
            route, stream = fut.result()
            tl = min(at_level, stream.levels)
            mp = stream.orig_shape[0] * stream.orig_shape[1] / 1e6
            timer = None
            if route == "host":
                rec = host_decode.host_decode(stream, target_level=tl)
                n_host += 1
            else:
                timer = _DeviceTimer(stream.ll.device)
                rec = decode_at_level(stream, tl, emit_u8=True) if tl else decode(stream, emit_u8=True)
                timer.stop()
            writes.append(pool.submit(_write, rec, out_dir / (src.stem + suffix), timer,
                                      mp / (1 << (2 * tl))))
            n += 1
            mp_total += mp
            bytes_in += src.stat().st_size
        bytes_out = sum(w.result() for w in writes)
    seconds = time.perf_counter() - t0
    return {
        "images": n,
        "resumed": n_resumed,
        "megapixels": round(mp_total, 4),
        "seconds": round(seconds, 3),
        "mp_per_s": round(mp_total / max(seconds, 1e-9), 2),
        "bytes_in": bytes_in,
        "bytes_out": bytes_out,
        "host_decoded": n_host,
        "device_decoded": n - n_host,
    }
