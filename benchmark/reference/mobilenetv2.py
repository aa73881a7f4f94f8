"""Plain MobileNetV2 (Sandler et al. 2018, arXiv:1801.04381; Keras
Applications ``MobileNetV2(alpha=1.0)``) forward in float32 PyTorch.

The network, from the configuration's ``stem``, ``blocks`` (Table 2's t,
c, n, s rows), ``head`` and ``num_classes``: a 3x3 stride-2 convolution;
inverted residual blocks (a 1x1 expansion by t where t > 1, a 3x3
depthwise convolution with the block's stride, a linear 1x1 projection,
the input added back where the stride is 1 and the width is unchanged);
a 1x1 convolution to ``head`` channels; the spatial mean; a dense layer.
Each convolution is followed by inference-mode batch normalization
(``bn_eps``) and, but for the projection, by ReLU6. Padding is
TensorFlow's ``SAME`` (``pad = max((ceil(n/s)-1)*s + k - n, 0)``, the
smaller half first), so a stride-2 layer on an even size pads (0, 1).

Weights are a flat list in layer order: per convolution its OIHW weight
(no bias), then the normalization's scale, offset, mean and variance; the
dense layer's (out, in) weight and its bias. :func:`make_weights` draws
them from a seed on a device in a few large calls. The forward runs with
TF32 off; ``fp8=True`` rounds every layer's input and weight to float8
e4m3 (per-tensor scale) first: the control.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ConvBN:
    cin: int
    cout: int
    k: int
    stride: int
    groups: int
    act: bool


@dataclass(frozen=True)
class Block:
    convs: tuple
    residual: bool


@dataclass(frozen=True)
class Dense:
    cin: int
    cout: int


def layers(config: dict) -> list:
    """The network's units in order: ConvBN, Block and Dense."""
    stem = config["stem"]
    units: list = [ConvBN(3, stem, 3, 2, 1, True)]
    cin = stem
    for t, c, n, s in config["blocks"]:
        for i in range(n):
            stride, mid = (s if i == 0 else 1), cin * t
            convs = ([ConvBN(cin, mid, 1, 1, 1, True)] if t != 1 else []) + [
                ConvBN(mid, mid, 3, stride, mid, True), ConvBN(mid, c, 1, 1, 1, False)]
            units.append(Block(tuple(convs), stride == 1 and cin == c))
            cin = c
    units.append(ConvBN(cin, config["head"], 1, 1, 1, True))
    units.append(Dense(config["head"], config["num_classes"]))
    return units


def _convs(config: dict):
    for unit in layers(config):
        yield from (unit.convs if isinstance(unit, Block) else (unit,))


def weight_shapes(config: dict) -> list[tuple]:
    """Shapes of the flat weight list, in order."""
    shapes = []
    for conv in _convs(config):
        if isinstance(conv, Dense):
            shapes += [(conv.cout, conv.cin), (conv.cout,)]
        else:
            shapes += [(conv.cout, conv.cin // conv.groups, conv.k, conv.k)] + [(conv.cout,)] * 4
    return shapes


def make_weights(config: dict, seed: int, device) -> list[torch.Tensor]:
    """Seeded weights: He-normal convolutions (LeCun for the projections
    and the head), normalization scale and variance uniform in [0.8, 1.2],
    offset and mean normal(0, 0.05), dense bias normal(0, 0.01). Two draws
    on ``device``: one normal and one uniform vector, sliced per leaf."""
    shapes = weight_shapes(config)
    sizes = [math.prod(s) for s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device) * 0.4 + 0.8
    out, off, i = [], 0, 0
    for conv in _convs(config):
        if isinstance(conv, Dense):
            roles = [("normal", 1 / math.sqrt(conv.cin)), ("normal", 0.01)]
        else:
            fan_in = conv.cin // conv.groups * conv.k * conv.k
            std = math.sqrt((2.0 if conv.act else 1.0) / fan_in)
            roles = [("normal", std), ("uniform", 1.0), ("normal", 0.05), ("normal", 0.05), ("uniform", 1.0)]
        for kind, scale in roles:
            n = sizes[i]
            src = normal if kind == "normal" else uniform
            out.append((src[off : off + n] * scale).reshape(shapes[i]))
            off, i = off + n, i + 1
    return out


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def forward(x: torch.Tensor, weights: list[torch.Tensor], config: dict, fp8: bool = False) -> torch.Tensor:
    """``x``: NHWC float32 (preprocessed to [-1, 1]) -> float32 logits."""
    q = _fp8 if fp8 else (lambda t: t)
    eps = config["bn_eps"]
    it = iter(weights)
    with _no_tf32():
        h = x.permute(0, 3, 1, 2).float()

        def conv_bn(h, conv):
            w, g, b, m, v = (next(it).float() for _ in range(5))
            y = F.conv2d(_same_pad(q(h), conv.k, conv.stride), q(w), None, conv.stride, 0, 1, conv.groups)
            y = (y - m[:, None, None]) / torch.sqrt(v + eps)[:, None, None] * g[:, None, None] + b[:, None, None]
            return y.clamp(0, 6) if conv.act else y

        for unit in layers(config):
            if isinstance(unit, Block):
                y = h
                for conv in unit.convs:
                    y = conv_bn(y, conv)
                h = y + h if unit.residual else y
            elif isinstance(unit, ConvBN):
                h = conv_bn(h, unit)
            else:
                w, b = next(it).float(), next(it).float()
                h = q(h.mean(dim=(2, 3))) @ q(w).T + b
    return h


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
