"""Keras H5 weights onto the port's classifier zoo (counterpart of
``wicca_tpu/models/convert.py``).

A ``tensorflow.keras.applications`` H5 weights file (the legacy layout:
``layer_names``/``weight_names`` attributes, one group per layer; read with
h5py, no TensorFlow) is bound through the JAX package's schemas — the
ordered ``(keras_layer_name, flax_param_path, kind)`` triples, copied here —
onto the Flax-path tree of a port model (:func:`wicca_tpu_torch.models.
interop.to_flax_variables`), and carried into a state dict by
:func:`wicca_tpu_torch.models.interop.carry` (:func:`map_weights`) or
written as the JAX converter's ``.msgpack`` (:func:`convert_h5`). So a file
gives the port the
weights it gives the JAX zoo, leaf for leaf, with the same errors for a
missing layer, a shape mismatch or an uncovered module.

Layout notes: Keras and Flax both store conv kernels HWIO and dense kernels
(in, out); Keras stores depthwise kernels ``(kh, kw, C, 1)``, Flax
``(kh, kw, 1, C)``. BatchNorm splits across ``params`` (scale, bias) and
``batch_stats`` (mean, var).

Coverage: VGG16/19, ResNet50, MobileNetV2, EfficientNetB0, DenseNet121,
NASNetMobile (the checkpoint graph, :mod:`wicca_tpu_torch.models.nasnet_keras`).
:func:`fetch_keras_weights` downloads a pretrained file through TensorFlow
where it is installed; nothing else here reaches a network.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
from torch import nn

# weight kinds
CONV = "conv"        # [kernel] or [kernel, bias], HWIO
DWCONV = "dwconv"    # [kernel] (kh, kw, C, 1) -> flax (kh, kw, 1, C)
BN = "bn"            # [gamma, beta, moving_mean, moving_variance]
DENSE = "dense"      # [kernel, bias], (in, out)
SEPCONV = "sepconv"  # keras SeparableConv2D: [dw (kh,kw,C,1), pw (1,1,C,F)]
                     # -> flax submodule {Conv_0: depthwise, Conv_1: pointwise}

# Keras layers carrying state that is not model weights (EfficientNet embeds
# its preprocessing); skipped with a note.
_SKIP_LAYERS = ("rescaling", "normalization", "resizing")


# ---------------------------------------------------------------------------
# Schemas: (keras_layer_name, flax_path, kind), flax_path into params['params']
# ---------------------------------------------------------------------------


def _schema_vgg(reps: tuple[int, ...]) -> list[tuple[str, tuple, str]]:
    out, n = [], 0
    for b, r in enumerate(reps, start=1):
        for i in range(1, r + 1):
            out.append((f"block{b}_conv{i}", (f"Conv_{n}",), CONV))
            n += 1
    out += [
        ("fc1", ("Dense_0",), DENSE),
        ("fc2", ("Dense_1",), DENSE),
        ("predictions", ("Dense_2",), DENSE),
    ]
    return out


def _schema_resnet50() -> list[tuple[str, tuple, str]]:
    out = [
        ("conv1_conv", ("Conv_0",), CONV),
        ("conv1_bn", ("BatchNorm_0",), BN),
    ]
    k = 0
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(1, blocks + 1):
            p = f"conv{stage + 2}_block{b}"
            blk = f"_Bottleneck_{k}"
            if b == 1:  # channel change -> conv shortcut (keras defines it first)
                out.append((f"{p}_0_conv", (blk, "_ConvBN_3", "Conv_0"), CONV))
                out.append((f"{p}_0_bn", (blk, "_ConvBN_3", "BatchNorm_0"), BN))
            for j in range(1, 4):
                out.append((f"{p}_{j}_conv", (blk, f"_ConvBN_{j - 1}", "Conv_0"), CONV))
                out.append((f"{p}_{j}_bn", (blk, f"_ConvBN_{j - 1}", "BatchNorm_0"), BN))
            k += 1
    out.append(("predictions", ("Dense_0",), DENSE))
    return out


def _schema_mobilenet_v2() -> list[tuple[str, tuple, str]]:
    out = [
        ("Conv1", ("_ConvBN_0", "Conv_0"), CONV),
        ("bn_Conv1", ("_ConvBN_0", "BatchNorm_0"), BN),
    ]
    config = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
    k = 0
    for t, _c, n, _s in config:
        for _ in range(n):
            blk = f"_InvertedResidual_{k}"
            if t == 1:  # first block: no expansion conv
                p = "expanded_conv"
                out += [
                    (f"{p}_depthwise", (blk, "_ConvBN_0", "Conv_0"), DWCONV),
                    (f"{p}_depthwise_BN", (blk, "_ConvBN_0", "BatchNorm_0"), BN),
                    (f"{p}_project", (blk, "_ConvBN_1", "Conv_0"), CONV),
                    (f"{p}_project_BN", (blk, "_ConvBN_1", "BatchNorm_0"), BN),
                ]
            else:
                p = f"block_{k}"
                out += [
                    (f"{p}_expand", (blk, "_ConvBN_0", "Conv_0"), CONV),
                    (f"{p}_expand_BN", (blk, "_ConvBN_0", "BatchNorm_0"), BN),
                    (f"{p}_depthwise", (blk, "_ConvBN_1", "Conv_0"), DWCONV),
                    (f"{p}_depthwise_BN", (blk, "_ConvBN_1", "BatchNorm_0"), BN),
                    (f"{p}_project", (blk, "_ConvBN_2", "Conv_0"), CONV),
                    (f"{p}_project_BN", (blk, "_ConvBN_2", "BatchNorm_0"), BN),
                ]
            k += 1
    out += [
        ("Conv_1", ("_ConvBN_1", "Conv_0"), CONV),
        ("Conv_1_bn", ("_ConvBN_1", "BatchNorm_0"), BN),
        ("predictions", ("Dense_0",), DENSE),
    ]
    return out


def _schema_efficientnet_b0() -> list[tuple[str, tuple, str]]:
    out = [
        ("stem_conv", ("Conv_0",), CONV),
        ("stem_bn", ("BatchNorm_0",), BN),
    ]
    config = ((1, 16, 1), (6, 24, 2), (6, 40, 2), (6, 80, 3),
              (6, 112, 3), (6, 192, 4), (6, 320, 1))
    k = 0
    for stage, (t, _c, n) in enumerate(config, start=1):
        for i in range(n):
            p = f"block{stage}{chr(ord('a') + i)}"
            blk = f"_MBConv_{k}"
            if t != 1:
                out += [
                    (f"{p}_expand_conv", (blk, "_ConvBN_0", "Conv_0"), CONV),
                    (f"{p}_expand_bn", (blk, "_ConvBN_0", "BatchNorm_0"), BN),
                ]
            proj = "_ConvBN_1" if t != 1 else "_ConvBN_0"
            out += [
                (f"{p}_dwconv", (blk, "Conv_0"), DWCONV),
                (f"{p}_bn", (blk, "BatchNorm_0"), BN),
                (f"{p}_se_reduce", (blk, "_SqueezeExcite_0", "Conv_0"), CONV),
                (f"{p}_se_expand", (blk, "_SqueezeExcite_0", "Conv_1"), CONV),
                (f"{p}_project_conv", (blk, proj, "Conv_0"), CONV),
                (f"{p}_project_bn", (blk, proj, "BatchNorm_0"), BN),
            ]
            k += 1
    out += [
        ("top_conv", ("_ConvBN_0", "Conv_0"), CONV),
        ("top_bn", ("_ConvBN_0", "BatchNorm_0"), BN),
        ("predictions", ("Dense_0",), DENSE),
    ]
    return out


def _schema_densenet121() -> list[tuple[str, tuple, str]]:
    out = [
        ("conv1/conv", ("Conv_0",), CONV),
        ("conv1/bn", ("BatchNorm_0",), BN),
    ]
    k = 0
    stage_layers = (6, 12, 24, 16)
    for si, layers in enumerate(stage_layers):
        stage = si + 2
        for i in range(1, layers + 1):
            p = f"conv{stage}_block{i}"
            blk = f"_DenseBlockLayer_{k}"
            out += [
                (f"{p}_0_bn", (blk, "BatchNorm_0"), BN),
                (f"{p}_1_conv", (blk, "Conv_0"), CONV),
                (f"{p}_1_bn", (blk, "BatchNorm_1"), BN),
                (f"{p}_2_conv", (blk, "Conv_1"), CONV),
            ]
            k += 1
        if si != len(stage_layers) - 1:
            out += [
                (f"pool{stage}_bn", (f"BatchNorm_{si + 1}",), BN),
                (f"pool{stage}_conv", (f"Conv_{si + 1}",), CONV),
            ]
    out += [
        ("bn", ("BatchNorm_4",), BN),
        ("predictions", ("Dense_0",), DENSE),
    ]
    return out


def _schema_nasnet_mobile() -> list[tuple[str, tuple, str]]:
    """NASNet-A mobile (4 @ 1056): replay the cell wiring of the JAX
    package's ``models/nasnet_keras.NASNetMobileKeras`` with (H, C) shape
    tracking — the adjust-block variant per cell depends on geometry,
    exactly like the Keras functional graph. Layer names equal Keras layer
    names, so every entry maps (name, (name,), kind)."""
    out: list[tuple[str, tuple, str]] = []

    def sep(block_id):
        for i in (1, 2):
            out.append((f"separable_conv_{i}_{block_id}", (f"separable_conv_{i}_{block_id}",), SEPCONV))
            out.append((f"separable_conv_{i}_bn_{block_id}", (f"separable_conv_{i}_bn_{block_id}",), BN))

    def simple(name, kind):
        out.append((name, (name,), kind))

    def adjust(p, ip, filters, bid):
        # p/ip are (H, C) or None; returns adjusted p shape
        if p is None:
            return ip
        if p[0] != ip[0]:
            simple(f"adjust_conv_1_{bid}", CONV)
            simple(f"adjust_conv_2_{bid}", CONV)
            simple(f"adjust_bn_{bid}", BN)
            return (ip[0], 2 * (filters // 2))
        if p[1] != filters:
            simple(f"adjust_conv_projection_{bid}", CONV)
            simple(f"adjust_bn_{bid}", BN)
            return (p[0], filters)
        return p

    def normal(ip, p, filters, bid):
        p = adjust(p, ip, filters, bid)
        simple(f"normal_conv_1_{bid}", CONV)
        simple(f"normal_bn_1_{bid}", BN)
        for b in ("left1", "right1", "left2", "right2", "left5"):
            sep(f"normal_{b}_{bid}")
        return (ip[0], 6 * filters), ip

    def reduction(ip, p, filters, bid):
        p = adjust(p, ip, filters, bid)
        simple(f"reduction_conv_1_{bid}", CONV)
        simple(f"reduction_bn_1_{bid}", BN)
        for b in ("left1", "right1", "right2", "right3", "left4"):
            sep(f"reduction_{b}_{bid}")
        return (-(-ip[0] // 2), 4 * filters), ip

    f, nb = 44, 4
    simple("stem_conv1", CONV)
    simple("stem_bn1", BN)
    x, p = (111, 32), None
    x, p = reduction(x, p, f // 4, "stem_1")
    x, p = reduction(x, p, f // 2, "stem_2")
    for i in range(nb):
        x, p = normal(x, p, f, f"{i}")
    x, p = reduction(x, p, f * 2, f"reduce_{nb}")
    for i in range(nb):
        x, p = normal(x, p, f * 2, f"{nb + i + 1}")
    x, p = reduction(x, p, f * 4, f"reduce_{2 * nb}")
    for i in range(nb):
        x, p = normal(x, p, f * 4, f"{2 * nb + i + 1}")
    simple("predictions", DENSE)
    return out


SCHEMAS = {
    "VGG16": lambda: _schema_vgg((2, 2, 3, 3, 3)),
    "VGG19": lambda: _schema_vgg((2, 2, 4, 4, 4)),
    "ResNet50": _schema_resnet50,
    "MobileNetV2": _schema_mobilenet_v2,
    "EfficientNetB0": _schema_efficientnet_b0,
    "DenseNet121": _schema_densenet121,
    "NASNetMobile": _schema_nasnet_mobile,
}


# keras.applications download identifiers for fetch_keras_weights
_KERAS_FACTORIES = {
    "VGG16": ("tensorflow.keras.applications", "VGG16"),
    "VGG19": ("tensorflow.keras.applications", "VGG19"),
    "ResNet50": ("tensorflow.keras.applications", "ResNet50"),
    "MobileNetV2": ("tensorflow.keras.applications", "MobileNetV2"),
    "EfficientNetB0": ("tensorflow.keras.applications", "EfficientNetB0"),
    "DenseNet121": ("tensorflow.keras.applications", "DenseNet121"),
    "NASNetMobile": ("tensorflow.keras.applications", "NASNetMobile"),
}


def convertible_architectures() -> tuple[str, ...]:
    return tuple(SCHEMAS)


# ---------------------------------------------------------------------------
# H5 reading (h5py only; handles weights-only and full-model files)
# ---------------------------------------------------------------------------


def read_keras_h5(path: str | Path) -> dict[str, list[np.ndarray]]:
    """Keras H5 -> {layer_name: [weight arrays in keras order]}."""
    import h5py

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        if "layer_names" in root.attrs:
            names = [n.decode() if isinstance(n, bytes) else n for n in root.attrs["layer_names"]]
        else:
            names = list(root.keys())
        out: dict[str, list[np.ndarray]] = {}
        for name in names:
            if name not in root:
                continue
            g = root[name]
            wnames = g.attrs.get("weight_names", [])
            wnames = [w.decode() if isinstance(w, bytes) else w for w in wnames]
            arrs = [np.asarray(g[w]) for w in wnames]
            if arrs:
                out[name] = arrs
        return out


# ---------------------------------------------------------------------------
# Mapping
# ---------------------------------------------------------------------------


def _get(tree, path):
    for k in path:
        if k not in tree:
            raise KeyError(f"flax path {'/'.join(path)} missing at {k!r}; have {sorted(tree)}")
        tree = tree[k]
    return tree


def _set(tree, path, leaf, value):
    node = _get(tree, path)
    want = node[leaf].shape
    if tuple(value.shape) != tuple(want):
        raise ValueError(f"shape mismatch at {'/'.join(path)}/{leaf}: keras {value.shape} vs flax {want}")
    node[leaf] = value.astype(np.asarray(node[leaf]).dtype)


def _to_mutable(tree):
    if isinstance(tree, dict) or type(tree).__name__ == "FrozenDict":
        return {k: _to_mutable(v) for k, v in tree.items()}
    return np.asarray(tree)


def _bind(arch: str, keras_weights: dict[str, list[np.ndarray]], variables) -> tuple[dict, dict]:
    """Bind Keras layer weights onto a Flax variables dict (the JAX
    package's ``map_weights``, verbatim in what it checks and raises).

    Returns ``(new_variables, report)``. Raises on any shape mismatch,
    missing schema layer, or Flax leaf left unassigned (full coverage).
    """
    if arch not in SCHEMAS:
        raise ValueError(f"no conversion schema for {arch!r}; have {sorted(SCHEMAS)}")
    schema = SCHEMAS[arch]()
    tree = _to_mutable(variables)
    params, stats = tree["params"], tree.get("batch_stats", {})
    assigned: set[tuple] = set()
    missing: list[str] = []

    for kname, fpath, kind in schema:
        if kname not in keras_weights:
            missing.append(kname)
            continue
        arrs = keras_weights[kname]
        if kind == BN:
            if len(arrs) != 4:
                raise ValueError(f"{kname}: expected 4 BN arrays, got {len(arrs)}")
            gamma, beta, mean, var = arrs
            _set(params, fpath, "scale", gamma)
            _set(params, fpath, "bias", beta)
            _set(stats, fpath, "mean", mean)
            _set(stats, fpath, "var", var)
            assigned.add(("params", *fpath))
            assigned.add(("batch_stats", *fpath))
        elif kind == SEPCONV:
            if len(arrs) != 2:
                raise ValueError(f"{kname}: expected [depthwise, pointwise], got {len(arrs)} arrays")
            dw, pw = arrs
            _set(params, (*fpath, "Conv_0"), "kernel", np.transpose(dw, (0, 1, 3, 2)))
            _set(params, (*fpath, "Conv_1"), "kernel", pw)
            assigned.add(("params", *fpath, "Conv_0"))
            assigned.add(("params", *fpath, "Conv_1"))
        elif kind in (CONV, DENSE, DWCONV):
            kernel = arrs[0]
            if kind == DWCONV:
                kernel = np.transpose(kernel, (0, 1, 3, 2))  # (kh,kw,C,1)->(kh,kw,1,C)
            _set(params, fpath, "kernel", kernel)
            node = _get(params, fpath)
            if "bias" in node:
                if len(arrs) < 2:
                    raise ValueError(f"{kname}: flax layer expects a bias, keras has none")
                _set(params, fpath, "bias", arrs[1])
            elif len(arrs) > 1:
                raise ValueError(f"{kname}: keras has a bias, flax layer does not")
            assigned.add(("params", *fpath))
        else:  # pragma: no cover - schema kinds are closed
            raise ValueError(f"unknown kind {kind!r}")

    if missing:
        raise ValueError(
            f"{arch}: keras file is missing layers {missing[:8]}{'...' if len(missing) > 8 else ''} "
            f"(have {len(keras_weights)} layers) — wrong architecture or weights file?"
        )

    # full coverage: every module holding params must have been assigned
    def _leaf_modules(tree, col, prefix=()):
        if isinstance(tree, dict) and tree and all(not isinstance(v, dict) for v in tree.values()):
            yield (col, *prefix)
            return
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from _leaf_modules(v, col, (*prefix, k))

    unassigned = [p for p in _leaf_modules(params, "params") if p not in assigned]
    unassigned += [p for p in _leaf_modules(stats, "batch_stats") if p not in assigned]
    if unassigned:
        raise ValueError(f"{arch}: {len(unassigned)} flax modules not covered by the schema: "
                         f"{['/'.join(p) for p in unassigned[:6]]}")

    skipped = [n for n in keras_weights if n not in {s[0] for s in schema}]
    genuinely_skipped = [n for n in skipped if any(t in n for t in _SKIP_LAYERS)]
    unexpected = [n for n in skipped if n not in genuinely_skipped]
    report = {
        "converted": len(schema) - len(missing),
        "skipped_preprocessing": genuinely_skipped,
        "unexpected_keras_layers": unexpected,
    }
    return tree, report


def map_weights(arch: str, keras_weights: dict[str, list[np.ndarray]], model: nn.Module) -> tuple[dict, dict]:
    """Bind Keras layer weights onto the port's ``model`` of ``arch``.

    Returns ``(state_dict, report)``: a state dict that
    ``model.load_state_dict(strict=True)`` takes, and the JAX package's
    report. Raises on any shape mismatch, missing schema layer, or module
    left uncovered."""
    from wicca_tpu_torch.models.interop import carry

    tree, report = _flax_tree(arch, keras_weights, model)
    return carry(tree, model), report


def _flax_tree(arch: str, keras_weights: dict[str, list[np.ndarray]], model: nn.Module) -> tuple[dict, dict]:
    """The Keras weights bound onto ``model``'s Flax-layout variables, and
    the report (see :func:`map_weights`)."""
    from wicca_tpu_torch.models.interop import to_flax_variables

    if arch not in SCHEMAS:
        raise ValueError(f"no conversion schema for {arch!r}; have {sorted(SCHEMAS)}")
    return _bind(arch, keras_weights, to_flax_variables(model))


def convert_h5(arch: str, h5_path: str | Path, out_dir: str | Path) -> Path:
    """Keras H5 weights -> ``<out_dir>/<arch>.msgpack``, the file
    ``wicca_tpu.models.convert.convert_h5`` writes (flax's bytes of the
    model's variables, by :func:`wicca_tpu_torch.models.flax_msgpack.write`),
    which both packages' registries read
    (:func:`wicca_tpu_torch.models.registry.load_single_model` with
    ``WICCA_TPU_WEIGHTS=<out_dir>``), for the model at 224x224."""
    from wicca_tpu_torch.models import flax_msgpack
    from wicca_tpu_torch.models.registry import build

    tree, report = _flax_tree(arch, read_keras_h5(h5_path), build(arch))
    if report["unexpected_keras_layers"]:
        logging.warning(f"{arch}: unmapped keras layers {report['unexpected_keras_layers']}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}.msgpack"
    out.write_bytes(flax_msgpack.write(tree))
    logging.info(f"{arch}: converted {report['converted']} layers -> {out}")
    return out


def fetch_keras_weights(arch: str, cache_dir: str | Path) -> Path:
    """Download the pretrained Keras H5 of ``arch`` through TensorFlow
    (needs tensorflow and a network) into ``<cache_dir>/<arch>_imagenet.h5``
    and return its path, for :func:`convert_h5`. Without TensorFlow it
    raises :class:`RuntimeError`; offline, convert a file downloaded
    elsewhere with :func:`convert_h5` directly."""
    import importlib

    try:
        mod_name, cls_name = _KERAS_FACTORIES[arch]
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise RuntimeError(
            "tensorflow is required to download pretrained weights; pass a "
            "pre-downloaded .h5 file instead"
        ) from e
    model = getattr(mod, cls_name)(weights="imagenet")
    path = Path(cache_dir) / f"{arch}_imagenet.h5"
    model.save_weights(str(path))
    return path
