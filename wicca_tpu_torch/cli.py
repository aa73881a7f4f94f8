"""Command-line interface of the PyTorch port (counterpart of
``wicca_tpu/cli.py``: the same subcommands, flags, defaults, printed lines
and exit codes, plus ``--device``, default ``cuda``; ``--device cpu`` runs
the plain PyTorch twins of the kernels on the CPU).

Subcommands:
  analyze       folder of images -> per-depth comparison CSVs (ClassifierProcessor)
  encode        image file -> .wct codestream (DWT + quantize + entropy coding)
  decode        .wct -> reconstructed image file (+ PSNR vs an optional original)
  encode-batch  folder -> .wct files, host IO overlapped with device encodes
  decode-batch  folder of .wct -> images
  icon          image file -> LL icon image at a given depth (reference-parity)
  compare       results folder -> classifier x depth comparison CSV
  transcode     .wct -> .wct without the DWT (drop layers/levels, swap codec)
  info          .wct structure and integrity
"""

from __future__ import annotations

import argparse
import sys


def _cmd_analyze(args) -> int:
    from wicca_tpu_torch.core.quant import QuantSpec
    from wicca_tpu_torch.harness.processor import ClassifierProcessor
    from wicca_tpu_torch.models.registry import load_models

    models = {name: (name, {"shape": (args.input_size, args.input_size)}) for name in args.models}
    classifiers = load_models(models, device=args.device)
    missing = [k for k, v in classifiers.items() if v is None]
    if missing:
        print(f"error: unknown model(s): {missing}", file=sys.stderr)
        return 2
    proc = ClassifierProcessor(
        args.data_folder,
        transform_depth=tuple(args.depths),
        interpolation=3,
        top_classes=args.top,
        results_folder=args.results_folder,
        log_info=not args.quiet,
        parallel=args.threads,
        batch_size=args.batch_size,
        resume=args.resume,
        compare=args.compare,
        codec_spec=None if args.compare == "icon" else QuantSpec(base_step=args.step),
        codec_wavelet=args.codec_wavelet,
        codec_color=args.codec_color,
        device=args.device,
    )
    proc.process_classifiers(classifiers, timeout=args.timeout)
    return 0


def _meta_items(items) -> dict | None:
    """``KEY=VALUE`` items as a dict, or None (with the error printed) when
    one has no ``=``."""
    try:
        return dict(item.split("=", 1) for item in items)
    except ValueError:
        print("error: --meta items must be key=value", file=sys.stderr)
        return None


def _cmd_encode(args) -> int:
    import numpy as np

    from wicca_tpu_torch.codec import encode, save
    from wicca_tpu_torch.core.quant import QuantSpec
    from wicca_tpu_torch.data.loader import load_image, load_image_raw, to_planar

    # hi-depth sources (16-bit PNG/TIFF) keep their precision; everything
    # else goes through the reference-contract uint8 loader
    raw = load_image_raw(args.input, keep_alpha=args.keep_alpha)
    if (
        (args.bit_depth or 8) > 8
        or (raw is not None and raw.dtype == np.uint16 and args.bit_depth is None)
        or (args.keep_alpha and raw is not None and raw.ndim == 3 and raw.shape[2] == 4)
    ):
        image = raw
    else:
        image = load_image(args.input)
    if image is None:
        print(f"error: cannot read image {args.input}", file=sys.stderr)
        return 2
    if image.dtype != np.uint8 and (args.target_bpp is not None or args.target_psnr is not None):
        print("error: rate control supports 8-bit sources only", file=sys.stderr)
        return 2
    if args.target_bpp is not None and args.target_psnr is not None:
        print("error: --target-bpp and --target-psnr are mutually exclusive", file=sys.stderr)
        return 2
    planar = to_planar(image)
    dev = args.device
    note = ""
    if args.target_bpp is not None and args.rate_control == "pcrd":
        # one fine encode + R-D-optimal per-plane truncation (codec.rd)
        from wicca_tpu_torch.codec.rd import truncate
        from wicca_tpu_torch.codec.transfer import fetch_stream

        fine = encode(
            planar, levels=args.levels,
            spec=QuantSpec(base_step=min(args.step, 0.5), hh_gain=args.hh_gain),
            wavelet=args.wavelet, color=args.color, chroma_gain=args.chroma_gain, device=dev,
        )
        stream = truncate(fetch_stream(fine), target_bpp=args.target_bpp, codec=args.codec)
        nz = sum(1 for d in (stream.band_div or ()) if d > 1)
        note = f"  [pcrd: {nz} plane(s) truncated for {args.target_bpp} bpp]"
    elif args.target_bpp is not None:
        from wicca_tpu_torch.codec import encode_to_bpp

        stream, info = encode_to_bpp(
            planar, args.target_bpp, levels=args.levels, wavelet=args.wavelet,
            color=args.color, chroma_gain=args.chroma_gain, rate="actual", codec=args.codec, device=dev,
        )
        note = f"  [rate control: step {info['step']:.3g}, {info['bpp']} bpp, {info['probes']} probes]"
    elif args.target_psnr is not None:
        from wicca_tpu_torch.codec import encode_to_psnr

        stream, info = encode_to_psnr(
            planar, args.target_psnr, levels=args.levels, wavelet=args.wavelet,
            color=args.color, chroma_gain=args.chroma_gain, device=dev,
        )
        note = f"  [rate control: step {info['step']:.3g}, {info['psnr_db']} dB, {info['probes']} probes]"
    else:
        # the folder pipeline's cost model: host or device, byte-identical
        from wicca_tpu_torch.codec.batch import _encode_route
        from wicca_tpu_torch.codec.host_encode import host_encode

        spec = QuantSpec(base_step=args.step, hh_gain=args.hh_gain)
        if _encode_route(image, args.wavelet, args.color, args.bit_depth, args.keep_alpha, "auto", dev) == "host":
            stream = host_encode(planar, levels=args.levels, spec=spec)
        else:
            stream = encode(planar, levels=args.levels, spec=spec, wavelet=args.wavelet, color=args.color,
                            chroma_gain=args.chroma_gain, bit_depth=args.bit_depth, device=dev)
    if args.roi is not None:
        from wicca_tpu_torch.codec import apply_roi

        r0, r1, c0, c1 = args.roi
        mask = np.zeros(stream.orig_shape, dtype=bool)
        mask[r0:r1, c0:c1] = True
        stream = apply_roi(stream, mask, bg_shift=args.roi_bg_shift)
        note += f"  [ROI [{r0}:{r1}, {c0}:{c1}), guard {stream.roi_shift} bits, bg -{args.roi_bg_shift} bits]"
    if args.meta:
        from wicca_tpu_torch.codec import with_metadata

        kv = _meta_items(args.meta)
        if kv is None:
            return 2
        stream = with_metadata(stream, kv)
        note += f"  [metadata: {', '.join(sorted(kv))}]"
    nbytes = save(stream, args.output, threads=args.threads, codec=args.codec,
                  quality_layers=args.quality_layers,
                  ll_codec=args.ll_codec, ll_step=args.ll_step)
    raw = int(image.nbytes)
    print(f"{args.input}: {raw} B -> {nbytes} B ({raw / nbytes:.2f}x) at depth {args.levels}{note}")
    return 0


def _cmd_encode_batch(args) -> int:
    import json

    from wicca_tpu_torch.codec.batch import encode_folder
    from wicca_tpu_torch.core.quant import QuantSpec

    meta = None
    if args.meta:
        meta = _meta_items(args.meta)
        if meta is None:
            return 2
    metrics = encode_folder(
        args.input_dir, args.output_dir, levels=args.levels,
        spec=QuantSpec(base_step=args.step, hh_gain=args.hh_gain), wavelet=args.wavelet,
        color=args.color, chroma_gain=args.chroma_gain, bit_depth=args.bit_depth,
        codec=args.codec, quality_layers=args.quality_layers, threads=args.threads,
        keep_alpha=args.keep_alpha, resume=args.resume, metadata=meta, path=args.path, device=args.device,
    )
    print(json.dumps(metrics))
    return 0


def _cmd_decode_batch(args) -> int:
    import json

    from wicca_tpu_torch.codec.batch import decode_folder

    metrics = decode_folder(
        args.input_dir, args.output_dir, threads=args.threads, on_error=args.on_error,
        at_level=args.at_level, resume=args.resume, path=args.path, device=args.device,
    )
    print(json.dumps(metrics))
    return 0


def _write_image(path: str, hwc) -> None:
    """An HWC (or HW) RGB(A) array as an image file through cv2."""
    import cv2

    if hwc.ndim == 3:
        hwc = cv2.cvtColor(hwc, cv2.COLOR_RGBA2BGRA if hwc.shape[2] == 4 else cv2.COLOR_RGB2BGR)
    cv2.imwrite(path, hwc)


def _cmd_decode(args) -> int:
    import numpy as np

    from wicca_tpu_torch.codec import decode, decode_region, load
    from wicca_tpu_torch.codec.batch import _decode_route
    from wicca_tpu_torch.codec.pipeline import decode_at_level
    from wicca_tpu_torch.codec.transfer import fetch_array_parallel, put_stream
    from wicca_tpu_torch.data.loader import from_planar

    stream = load(args.input, threads=args.threads, max_layers=args.max_layers,
                  allow_truncated=args.allow_truncated, on_error=args.on_error, device="cpu")
    if args.region is not None and args.at_level:
        print("error: --region and --at-level are mutually exclusive", file=sys.stderr)
        return 2
    if args.region is not None:
        r0, r1, c0, c1 = args.region
        rec = decode_region(put_stream(stream, args.device), r0, r1, c0, c1, emit_u8=True)
    elif _decode_route(stream, args.at_level, "auto", args.device) == "host":
        # the folder pipeline's cost model: the inverse on the host, bit-identically
        from wicca_tpu_torch.codec.host_decode import host_decode

        rec = host_decode(stream, target_level=min(args.at_level, stream.levels))
    elif args.at_level:
        # resolution-progressive: 1/2**r output from the coarse subbands only
        rec = decode_at_level(put_stream(stream, args.device), args.at_level, emit_u8=True)
    else:
        # native-dtype emission: uint8, or uint16 for hi-depth streams
        rec = decode(put_stream(stream, args.device), emit_u8=True)
    rec = fetch_array_parallel(rec)
    rec_hwc = from_planar(rec)
    if args.output.lower().endswith(".png") and rec.dtype == np.uint8:
        from wicca_tpu_torch.data.pngw import write_png  # strip-parallel native writer

        write_png(args.output, rec)
    else:
        _write_image(args.output, rec_hwc)
    msg = f"{args.input} -> {args.output} {rec_hwc.shape}"
    if stream.metadata:
        msg += f"  [metadata: {', '.join(sorted(k for k, _ in stream.metadata))}]"
    if args.original:
        import torch

        from wicca_tpu_torch.core.metrics import psnr
        from wicca_tpu_torch.data.loader import load_image, load_image_raw

        orig = load_image_raw(args.original) if stream.bit_depth > 8 else load_image(args.original)
        if orig is not None and orig.shape == rec_hwc.shape:
            peak = float((1 << stream.bit_depth) - 1)
            db = psnr(torch.from_numpy(rec_hwc.astype(np.float32)), torch.from_numpy(orig.astype(np.float32)),
                      peak=peak)
            msg += f"  PSNR {float(db):.2f} dB"
    print(msg)
    return 0


def _cmd_icon(args) -> int:
    from wicca_tpu_torch.data.loader import load_image
    from wicca_tpu_torch.harness.processor import _compute_icon

    if args.input.endswith(".wct"):
        # icon straight from the stream's coarse band: no full decode, no
        # transform; --depth/--wavelet are the stream's own
        from wicca_tpu_torch.codec import icon_from_stream, load
        from wicca_tpu_torch.codec.transfer import fetch_array_parallel
        from wicca_tpu_torch.data.loader import from_planar

        stream = load(args.input, device=args.device)
        icon = from_planar(fetch_array_parallel(icon_from_stream(stream)))
        _write_image(args.output, icon)
        print(f"{args.input} {stream.orig_shape} -> {args.output} {icon.shape[:2]}"
              f" (stream LL, {stream.wavelet} depth {stream.levels})")
        return 0
    image = load_image(args.input)
    if image is None:
        print(f"error: cannot read image {args.input}", file=sys.stderr)
        return 2
    if args.wavelet == "haar":
        icon = _compute_icon(image, args.depth, args.device)
    else:
        from wicca_tpu_torch.coder import LiftingCoder

        icon = LiftingCoder(args.wavelet).get_small_copy(image, args.depth, device=args.device)
    _write_image(args.output, icon)
    print(f"{args.input} {image.shape[:2]} -> {args.output} {icon.shape[:2]} (depth {args.depth})")
    return 0


def _cmd_compare(args) -> int:
    from wicca_tpu_torch.analysis.results import compare_summaries

    df = compare_summaries(args.results_folder, args.models, tuple(args.depths), args.stat)
    if df.empty:
        print("no results found", file=sys.stderr)
        return 1
    out = args.output or "-"
    if out == "-":
        print(df.to_string(index=False))
    else:
        df.to_csv(out, index=False)
        print(f"wrote {out} ({len(df)} rows)")
    return 0


def _cmd_transcode(args) -> int:
    """Reshape a .wct stream on the host (no DWT, no device): drop quality
    layers / finest levels, swap the entropy codec, re-layer."""
    from wicca_tpu_torch.codec.transcode import transcode

    try:
        m = transcode(
            args.input, args.output,
            max_layers=args.max_layers, drop_levels=args.drop_levels,
            codec=args.codec, quality_layers=args.layers,
            threads=args.threads, allow_truncated=args.allow_truncated,
            on_error=args.on_error,
        )
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    oh, ow = m["orig_shape"]
    print(f"{args.input} -> {args.output}: {m['bytes_in']:,} -> {m['bytes_out']:,} bytes"
          f" ({m['ratio']}x), {ow}x{oh} levels={m['levels']}")
    return 0


def _cmd_info(args) -> int:
    """Structural dump + CRC audit of .wct streams (no entropy decode, no
    device). Exit status 1 when any file fails verification."""
    import json

    from wicca_tpu_torch.codec.container import inspect

    bad = 0
    for path in args.inputs:
        try:
            info = inspect(path, verify=not args.no_verify)
        except (OSError, ValueError) as e:
            print(f"{path}: error: {e}", file=sys.stderr)
            bad += 1
            continue
        if args.json:
            print(json.dumps({"file": path, **info}))
            # a detectably-corrupt metadata box fails the audit even when no
            # CRC trailer exists / --no-verify skips the CRC pass
            if info["integrity"] == "corrupt" or info["metadata_error"]:
                bad += 1
            continue
        oh, ow = info["orig_shape"]
        print(f"{path}: WCT{info['version']}  {ow}x{oh}x{info['channels']}"
              f" @{info['bit_depth']}bpp  wavelet={info['wavelet']}"
              f" levels={info['levels']} layout={info['layout']} color={info['color']}")
        layers = (f"  layers={info['complete_layers']}/{info['quality_layers']}"
                  if info["quality_layers"] > 1 else "")
        roi = f"  roi_shift={info['roi_shift']}" if info["roi_shift"] else ""
        print(f"  step={info['base_step']:g} gain={info['level_gain']:g}"
              f"{layers}{roi}  ll={info['ll_shape'][2]}x{info['ll_shape'][1]}")
        print(f"  {info['total_bytes']:,} bytes = {info['bpp']:.3f} bpp"
              f"  ({info['compression_ratio']:.1f}x vs raw;"
              f" LL {info['ll_bytes']:,} + entropy {info['entropy_bytes']:,})")
        if info["metadata"]:
            pairs = ", ".join(f"{k} ({v}B)" for k, v in sorted(info["metadata"].items()))
            print(f"  metadata: {pairs}")
        state = info["integrity"] if info["checksummed"] else "no trailer (pre-checksum stream)"
        print(f"  integrity: {state}"
              + (f" — {', '.join(info['corrupt_sections'])}" if info["corrupt_sections"] else ""))
        if info["metadata_error"]:
            print(f"  metadata: CORRUPT — {info['metadata_error']}")
        if args.planes:
            for pl in info["planes"]:
                layer = f" layer={pl['layer']}" if "layer" in pl else ""
                _, sh, sw = pl["shape"]
                print(f"    L{pl['level']} {pl['band']}{layer}: {sw}x{sh}"
                      f" {pl['dtype']} {pl['codec']} {pl['nbytes']:,}B")
        if info["integrity"] == "corrupt" or info["metadata_error"]:
            bad += 1
    return 1 if bad else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="wicca_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="where the transforms and models run: cuda (default) or cpu (the kernels' plain twins)")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("analyze", help="run the CNN comparison harness over an image folder")
    a.add_argument("data_folder")
    a.add_argument("--models", nargs="+", default=["MobileNetV2"], help="registered architecture names")
    a.add_argument("--depths", nargs="+", type=int, default=[2, 3, 4, 5, 6])
    a.add_argument("--top", type=int, default=5)
    a.add_argument("--input-size", type=int, default=224)
    a.add_argument("--results-folder", default="results")
    a.add_argument("--batch-size", type=int, default=25)
    a.add_argument("--threads", type=int, default=8)
    a.add_argument("--timeout", type=int, default=None)
    a.add_argument("--resume", action="store_true", help="skip (model, depth) pairs with existing summaries")
    a.add_argument("--compare", default="icon", choices=["icon", "reconstruction"],
                   help="compare source vs LL icon (reference semantics) or vs the quantized codec roundtrip")
    a.add_argument("--step", type=float, default=1.0, help="codec quantization step for --compare reconstruction")
    a.add_argument("--codec-wavelet", default="haar",
                   choices=["haar", "db2", "bior4.4", "legall5.3"],
                   help="wavelet for --compare reconstruction")
    a.add_argument("--codec-color", default="none", choices=["none", "rct", "ict"],
                   help="color transform for --compare reconstruction")
    a.add_argument("--quiet", action="store_true")
    a.set_defaults(fn=_cmd_analyze)

    e = sub.add_parser("encode", help="encode an image to a .wct codestream")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--levels", type=int, default=5)
    e.add_argument("--step", type=float, default=1.0, help="deadzone quantization step")
    e.add_argument("--hh-gain", type=float, default=1.0,
                   help="visual weighting: quantize the diagonal (HH) band this much "
                        "coarser (CSF is least sensitive there; try 1.5-2)")
    e.add_argument("--ll-codec", default="raw", choices=["raw", "rice", "quant"],
                   help="LL-plane storage (WCT10): 'rice' = lossless Rice for integer LLs, "
                        "'quant' = midtread-quantize float LLs at --ll-step (raw float32 LL "
                        "is a rate floor at shallow depths)")
    e.add_argument("--ll-step", type=float, default=0.125,
                   help="LL quantization step for --ll-codec quant (default 0.125)")
    e.add_argument("--target-bpp", type=float, default=None,
                   help="rate control: meet this bits-per-pixel budget (overrides --step)")
    e.add_argument("--rate-control", default="pcrd", choices=["pcrd", "step"],
                   help="--target-bpp strategy: 'pcrd' (default) = one fine encode + "
                        "R-D-optimal per-plane truncation (WCT9; +2-3 dB at low rate, "
                        "also works for lossless wavelets); 'step' = re-encoding step search")
    e.add_argument("--target-psnr", type=float, default=None,
                   help="rate control: pick the coarsest step meeting this PSNR in dB (overrides --step)")
    e.add_argument(
        "--wavelet",
        default="haar",
        choices=["haar", "db2", "bior4.4", "legall5.3", "haar_int"],
        help="legall5.3 / haar_int produce a LOSSLESS stream (--step ignored)",
    )
    e.add_argument(
        "--color",
        default="none",
        choices=["none", "rct", "ict"],
        help="channel decorrelation: rct (reversible, integer wavelets) or ict (YCbCr, float wavelets)",
    )
    e.add_argument("--chroma-gain", type=float, default=1.0,
                   help="quantize ICT chroma this much coarser")
    e.add_argument("--threads", type=int, default=8)
    e.add_argument("--codec", default="auto", choices=["auto", "rice", "rc"],
                   help="detail-plane entropy codec: rice (fastest), rc (context-modeled "
                        "range coder, smaller), auto (per-plane smaller of the two)")
    e.add_argument("--bit-depth", type=int, default=None,
                   help="sample precision 8..16 (default: inferred — 16-bit PNG/TIFF "
                        "sources keep their precision; needs a lifting wavelet)")
    e.add_argument("--roi", nargs=4, type=int, metavar=("ROW0", "ROW1", "COL0", "COL1"),
                   default=None, help="region of interest kept at full fidelity (maxshift)")
    e.add_argument("--roi-bg-shift", type=int, default=2,
                   help="magnitude bits dropped outside the ROI (~6 dB each; 0 = reorder only)")
    e.add_argument("--quality-layers", type=int, default=1,
                   help="> 1 writes an SNR-scalable stream: any layer prefix decodes "
                        "at a coarser effective step (progressive transmission)")
    e.add_argument("--keep-alpha", action="store_true",
                   help="keep the alpha plane of RGBA sources (coded as a 4th "
                        "component; color transforms rotate RGB only)")
    e.add_argument("--meta", action="append", default=[], metavar="KEY=VALUE",
                   help="attach application metadata to the stream (repeatable; "
                        "carried in the container, shown by `info`, preserved by transcode)")
    e.set_defaults(fn=_cmd_encode)

    eb = sub.add_parser("encode-batch", help="encode a folder of images to .wct files "
                                             "(host IO overlapped with the device transform)")
    eb.add_argument("input_dir")
    eb.add_argument("output_dir")
    eb.add_argument("--levels", type=int, default=5)
    eb.add_argument("--step", type=float, default=1.0)
    eb.add_argument("--hh-gain", type=float, default=1.0)
    eb.add_argument("--wavelet", default="haar",
                    choices=["haar", "db2", "bior4.4", "cdf97", "legall5.3", "cdf53", "haar_int"])
    eb.add_argument("--color", default="none", choices=["none", "rct", "ict"])
    eb.add_argument("--chroma-gain", type=float, default=1.0)
    eb.add_argument("--bit-depth", type=int, default=None)
    eb.add_argument("--codec", default="auto", choices=["auto", "rice", "rc"])
    eb.add_argument("--quality-layers", type=int, default=1)
    eb.add_argument("--resume", action="store_true",
                    help="skip sources whose .wct already exists (restartable runs)")
    eb.add_argument("--keep-alpha", action="store_true",
                    help="keep the alpha plane of RGBA sources (coded as a 4th component)")
    eb.add_argument("--threads", type=int, default=8)
    eb.add_argument("--meta", action="append", default=[], metavar="KEY=VALUE",
                    help="attach the same metadata items to every produced stream (repeatable)")
    eb.add_argument("--path", default="auto", choices=["auto", "host", "device"],
                    help="transform backend: auto = measured-bandwidth cost model")
    eb.set_defaults(fn=_cmd_encode_batch)

    db = sub.add_parser("decode-batch", help="decode a folder of .wct files to images")
    db.add_argument("input_dir")
    db.add_argument("output_dir")
    db.add_argument("--threads", type=int, default=8)
    db.add_argument("--on-error", default="raise", choices=["raise", "zero"])
    db.add_argument("--at-level", type=int, default=0, metavar="R",
                    help="bulk previews: decode every stream at 1/2**R resolution")
    db.add_argument("--resume", action="store_true",
                    help="skip streams whose output image already exists")
    db.add_argument("--path", default="auto", choices=["auto", "host", "device"],
                    help="reconstruction backend: auto = measured-bandwidth cost model")
    db.set_defaults(fn=_cmd_decode_batch)

    d = sub.add_parser("decode", help="decode a .wct codestream to an image")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--original", default=None, help="original image for PSNR report")
    d.add_argument("--threads", type=int, default=8)
    d.add_argument("--max-layers", type=int, default=None,
                   help="decode only this many quality layers of a layered stream")
    d.add_argument("--allow-truncated", action="store_true",
                   help="accept a byte-truncated layered stream (decode complete layers)")
    d.add_argument("--region", nargs=4, type=int, metavar=("ROW0", "ROW1", "COL0", "COL1"),
                   default=None, help="decode only this pixel window (spatial random access)")
    d.add_argument("--at-level", type=int, default=0, metavar="R",
                   help="resolution-progressive decode at 1/2**R size (coarse subbands only)")
    d.add_argument("--on-error", default="raise", choices=["raise", "zero"],
                   help="'zero' decodes around checksum-corrupt detail planes instead of failing")
    d.set_defaults(fn=_cmd_decode)

    i = sub.add_parser("icon", help="extract the depth-d LL icon of an image"
                       " (or the coarse band of a .wct stream, decode-free)")
    i.add_argument("input", help="image file, or a .wct stream (LL extracted directly)")
    i.add_argument("output")
    i.add_argument("--depth", type=int, default=5)
    i.add_argument("--wavelet", default="haar", choices=["haar", "db2", "bior4.4", "legall5.3", "haar_int"])
    i.set_defaults(fn=_cmd_icon)

    t = sub.add_parser("transcode", help="rewrite a .wct stream without re-running the DWT "
                       "(drop layers/levels, swap entropy codec, re-layer)")
    t.add_argument("input")
    t.add_argument("output")
    t.add_argument("--max-layers", type=int, default=None,
                   help="keep only this many quality layers (SNR truncation)")
    t.add_argument("--drop-levels", type=int, default=0, metavar="R",
                   help="drop the finest R detail levels (1/2**R resolution stream)")
    t.add_argument("--codec", default="auto", choices=["auto", "rice", "rc"],
                   help="re-entropy-code the detail planes")
    t.add_argument("--layers", type=int, default=None,
                   help="re-layer to this many quality layers (default: preserve source layering)")
    t.add_argument("--threads", type=int, default=8)
    t.add_argument("--allow-truncated", action="store_true")
    t.add_argument("--on-error", default="raise", choices=["raise", "zero"])
    t.set_defaults(fn=_cmd_transcode)

    n = sub.add_parser("info", help="inspect a .wct codestream (header, sections, integrity)")
    n.add_argument("inputs", nargs="+", help=".wct file(s)")
    n.add_argument("--json", action="store_true", help="machine-readable dump (one JSON object per file)")
    n.add_argument("--planes", action="store_true", help="also list every detail-plane section")
    n.add_argument("--no-verify", action="store_true", help="skip CRC verification (faster on huge files)")
    n.set_defaults(fn=_cmd_info)

    c = sub.add_parser("compare", help="tabulate summaries across classifiers and depths")
    c.add_argument("results_folder")
    c.add_argument("--models", nargs="+", required=True)
    c.add_argument("--depths", nargs="+", type=int, required=True)
    c.add_argument("--stat", default="mean")
    c.add_argument("--output", default=None, help="CSV path or '-' for stdout")
    c.set_defaults(fn=_cmd_compare)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
