"""The classifier zoo in PyTorch (counterpart of
``wicca_tpu/models/flax_models.py``): ``SimpleCNN``, ``MobileNetV2``,
``ResNet50``, ``EfficientNetB0``, ``NASNetMobile`` (the paper's cells; the
registry's checkpoint graph is :mod:`wicca_tpu_torch.models.nasnet_keras`),
``VGG`` (``VGG16``, ``VGG19``), ``DenseNet121`` and ``ViT`` (``ViTS16``,
``ViTTiny16``), at their published widths.

Every model takes an NCHW float32 batch and returns float32 logits. The
Flax modules' numerics are mirrored:

* each submodule takes the name Flax gives it (the class name and its index
  among the siblings of that class: ``_InvertedResidual_3._ConvBN_1.Conv_0``),
  so :mod:`wicca_tpu_torch.models.interop` carries a Flax variable tree
  across mechanically;
* ``padding='SAME'`` is Flax's: ``pad_total = max((ceil(n/s)-1)*s + k - n, 0)``
  with the smaller half first, computed from the input size at each call (a
  stride-2 3x3 conv on an even input pads (0, 1));
* convolutions and their inputs run in the model's compute ``dtype``
  (bfloat16 where the Flax module defaults to it); BatchNorm, LayerNorm,
  residual sums, the pooling to logits and the heads run in float32 exactly
  where the Flax code casts;
* BatchNorm epsilon 1e-3 (``_ConvBN``, EfficientNet) or 1.001e-5
  (ResNet, DenseNet); LayerNorm epsilon 1e-6; ``gelu`` is the tanh form;
  attention scales the query by ``1/sqrt(head_dim)`` and is written as plain
  matmuls and a softmax;
* VGG flattens its last feature map in NHWC order, as the Flax model does.

VGG's first dense layer and ViT's position embedding depend on the input
size, so those two take ``image_size``; so do the NASNets, whose cells pick
their ``adjust`` path from the input's geometry (:class:`Compact`).
Parameters are created empty: :func:`init_weights` fills them
deterministically from a ``torch.Generator`` (values differ from JAX's
init), or a state dict is loaded.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_RESNET_EPS = 1.001e-5  # keras.applications ResNet/DenseNet BN epsilon


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """Flax/XLA 'SAME' padding (low, high) of one spatial dim of size ``n``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _Named(nn.Module):
    """A module whose children take Flax's automatic names. A subclass keeps
    its own references to them in tuples or lists (an attribute holding a
    module would register it a second time)."""

    def __init__(self):
        super().__init__()
        self._seen: dict[str, int] = {}

    def add(self, child: nn.Module, name: str | None = None) -> nn.Module:
        if name is None:
            kind = type(child).__name__
            idx = self._seen.get(kind, 0)
            self._seen[kind] = idx + 1
            name = f"{kind}_{idx}"
        self.add_module(name, child)
        return child


class Compact(_Named):
    """A module whose children are made during a call, as ``flax.linen.compact``
    makes them: :meth:`child` names a child by Flax's rule (its class name and
    its index among the siblings of that class made so far in this call, or
    an explicit name) and makes it on first use. A subclass writes its graph
    once, in ``_forward``; its constructor calls :meth:`_build`, which runs
    that graph on a meta input of ``image_size``, so each child is made with
    its input's shape and every shape-dependent branch is taken as Flax
    takes it at that size. A later call that asks for a child the build did
    not make, or made with other arguments, raises."""

    def __init__(self):
        super().__init__()
        self._building = True
        self._calls: dict[str, int] = {}
        self._made: dict[str, tuple] = {}  # name -> how it was made

    def child(self, cls, *args, name: str | None = None, **kw) -> nn.Module:
        if name is None:
            idx = self._calls.get(cls.__name__, 0)
            self._calls[cls.__name__] = idx + 1
            name = f"{cls.__name__}_{idx}"
        how = (cls, args, kw)
        if self._made.get(name) != how:
            if not self._building or name in self._made:
                raise ValueError(f"{type(self).__name__}: layer {name!r} was not made so by the build; this input "
                                 "takes a path that the module's image_size did not")
            self.add_module(name, cls(*args, **kw))
            self._made[name] = how
        return self._modules[name]

    def forward(self, *args):
        self._calls = {}
        return self._forward(*args)

    def _build(self, image_size) -> None:
        target = torch.empty(0).device  # the caller's default device (a torch.device context included)
        with torch.device("meta"):
            self(torch.zeros(1, 3, *image_size))
        for m in self.modules():
            if isinstance(m, Compact):
                m._building = False
        if target.type != "meta":
            self.to_empty(device=target)


# ---------------------------------------------------------------------------
# leaf layers (the Flax linen layers the zoo uses)
# ---------------------------------------------------------------------------


class Conv(nn.Module):
    """``flax.linen.Conv``: OIHW weight, input, weight and bias cast to
    ``dtype``; ``padding`` is 'SAME' or explicit ((top, bottom), (left, right))."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, groups: int = 1, bias: bool = True,
                 padding="SAME", dtype=torch.float32):
        super().__init__()
        self.kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        self.groups = groups
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, *self.kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            (pt, pb), (pl, pr) = (same_padding(n, k, s) for n, k, s in zip(x.shape[-2:], self.kernel, self.stride))
        else:
            (pt, pb), (pl, pr) = self.padding
        x = x.to(self.dtype)
        pad = (pt, pl)
        if (pt, pl) != (pb, pr):
            x = F.pad(x, (pl, pr, pt, pb))
            pad = (0, 0)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride, pad, groups=self.groups)


class Dense(nn.Module):
    """``flax.linen.Dense``: (out, in) weight, input, weight and bias cast to
    ``dtype``."""

    def __init__(self, fin: int, fout: int, bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(use_running_average=True, dtype=float32)`` over
    the channel axis; float32 out. Where the running statistics require a
    gradient (the trainer, :mod:`wicca_tpu_torch.harness.train`, trains them
    as the JAX trainer does), it computes Flax's ``_normalize``,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, which autograd
    differentiates in all four."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.running_mean.requires_grad:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x.float() - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight, self.bias, False, 0.0,
                            self.eps)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=float32)`` over the last axis (epsilon
    1e-6, Flax's default); float32 out."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)


class MultiHeadDotProductAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` (self-attention, no mask,
    no dropout) as plain matmuls and a softmax in ``dtype``: the query scaled
    by ``1/sqrt(head_dim)`` first, as Flax does. ``query``/``key``/``value``
    hold Flax's (dim, heads, head_dim) kernels as (heads*head_dim, dim)
    weights, ``out`` its (heads, head_dim, dim) kernel as (dim,
    heads*head_dim)."""

    def __init__(self, dim: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(dim, dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, dim = x.shape
        hd = dim // self.heads

        def heads(y):
            return y.reshape(b, t, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1).to(self.dtype)
        return self.out((w @ v).transpose(1, 2).reshape(b, t, dim))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


class SimpleCNN(_Named):
    """Small deterministic CNN for tests and smoke runs (float32 by default,
    as its Flax twin)."""

    def __init__(self, num_classes: int = 1000, features: int = 16, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        self.convs = []
        for i in range(3):
            self.convs.append(self.add(Conv(cin, features * 2**i, 3, 2, dtype=dtype)))
            cin = features * 2**i
        self.head = (self.add(Dense(cin, num_classes)),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.head[0](x.mean(dim=(2, 3)))


class _ConvBN(_Named):
    def __init__(self, cin: int, features: int, kernel=3, stride=1, groups: int = 1, act: bool = True,
                 dtype=torch.bfloat16, bias: bool = False, eps: float = 1e-3, act_fn=F.relu6):
        super().__init__()
        self.parts = (self.add(Conv(cin, features, kernel, stride, groups, bias, dtype=dtype)),
                      self.add(BatchNorm(features, eps)))
        self.act_fn = act_fn if act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.parts
        x = bn(conv(x))
        return self.act_fn(x) if self.act_fn is not None else x


class _InvertedResidual(_Named):
    def __init__(self, inp: int, features: int, stride: int, expand: int, dtype=torch.bfloat16):
        super().__init__()
        mid = inp * expand
        self.layers = []
        if expand != 1:
            self.layers.append(self.add(_ConvBN(inp, mid, 1, dtype=dtype)))
        self.layers.append(self.add(_ConvBN(mid, mid, 3, stride, groups=mid, dtype=dtype)))
        self.layers.append(self.add(_ConvBN(mid, features, 1, act=False, dtype=dtype)))
        self.residual = stride == 1 and inp == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers:
            h = layer(h)
        return h + x if self.residual else h


class MobileNetV2(_Named):
    """MobileNetV2 (width 1.0), 224x224 -> 1000 logits."""

    # (expansion t, channels c, repeats n, stride s) per paper Table 2
    CONFIG: Sequence[tuple[int, int, int, int]] = (
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    )

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16):
        super().__init__()
        self.layers = [self.add(_ConvBN(3, 32, 3, 2, dtype=dtype))]
        cin = 32
        for t, c, n, s in self.CONFIG:
            for i in range(n):
                self.layers.append(self.add(_InvertedResidual(cin, c, s if i == 0 else 1, t, dtype=dtype)))
                cin = c
        self.layers.append(self.add(_ConvBN(cin, 1280, 1, dtype=dtype)))
        self.head = (self.add(Dense(1280, num_classes)),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.head[0](x.mean(dim=(2, 3)).float())


class _Bottleneck(_Named):
    """ResNet v1 bottleneck, keras.applications structure: the stride sits
    on the first 1x1 conv, convs carry biases, plain relu, BN eps 1.001e-5."""

    def __init__(self, cin: int, features: int, stride: int = 1, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(bias=True, eps=_RESNET_EPS, act_fn=F.relu, dtype=dtype)
        self.layers = [self.add(_ConvBN(cin, features, 1, stride, **kw)),
                       self.add(_ConvBN(features, features, 3, **kw)),
                       self.add(_ConvBN(features, features * 4, 1, act=False, **kw))]
        # Flax compares the shapes of x and h: in ResNet50 they differ exactly
        # where the channels do (every stride-2 block also widens)
        self.shortcut = [self.add(_ConvBN(cin, features * 4, 1, stride, act=False, **kw))
                         for _ in range(cin != features * 4)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers:
            h = layer(h)
        residual = self.shortcut[0](x) if self.shortcut else x
        return F.relu(h + residual)


class ResNet50(_Named):
    """ResNet-50 v1, 224x224 -> 1000 logits (explicit (3, 3) stem pad and
    (1, 1) pool pad, as keras.applications)."""

    STAGES: Sequence[tuple[int, int]] = ((64, 3), (128, 4), (256, 6), (512, 3))

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = (self.add(Conv(3, 64, 7, 2, padding=((3, 3), (3, 3)), dtype=dtype)),
                     self.add(BatchNorm(64, _RESNET_EPS)))
        self.blocks = []
        cin = 64
        for stage, (feat, blocks) in enumerate(self.STAGES):
            for i in range(blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                self.blocks.append(self.add(_Bottleneck(cin, feat, stride, dtype=dtype)))
                cin = feat * 4
        self.head = (self.add(Dense(cin, num_classes)),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.stem
        x = F.relu(bn(conv(x))).to(self.dtype)
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        return self.head[0](x.mean(dim=(2, 3)).float())


class _SqueezeExcite(_Named):
    def __init__(self, channels: int, features: int, se_ratio: float = 0.25, dtype=torch.bfloat16):
        super().__init__()
        hidden = max(1, int(features * se_ratio))
        self.convs = (self.add(Conv(channels, hidden, 1, dtype=dtype)),
                      self.add(Conv(hidden, channels, 1, dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        reduce, expand = self.convs
        s = expand(F.silu(reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class _MBConv(_Named):
    def __init__(self, inp: int, features: int, kernel: int, stride: int, expand: int, dtype=torch.bfloat16):
        super().__init__()
        mid = inp * expand
        self.expand = [self.add(_ConvBN(inp, mid, 1, act_fn=F.silu, dtype=dtype)) for _ in range(expand != 1)]
        self.parts = (self.add(Conv(mid, mid, kernel, stride, groups=mid, bias=False, dtype=dtype)),
                      self.add(BatchNorm(mid, 1e-3)), self.add(_SqueezeExcite(mid, inp, dtype=dtype)),
                      self.add(_ConvBN(mid, features, 1, act=False, dtype=dtype)))
        self.residual = stride == 1 and inp == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw, bn, se, project = self.parts
        h = self.expand[0](x) if self.expand else x
        h = project(se(F.silu(bn(dw(h)))))
        return h + x if self.residual else h


class EfficientNetB0(_Named):
    """EfficientNet-B0, 224x224 -> 1000 logits (silu activations + SE)."""

    # (expand, channels, repeats, stride, kernel) per paper Table 1
    CONFIG: Sequence[tuple[int, int, int, int, int]] = (
        (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3), (6, 112, 3, 1, 5),
        (6, 192, 4, 2, 5), (6, 320, 1, 1, 3),
    )

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16):
        super().__init__()
        self.stem = (self.add(Conv(3, 32, 3, 2, bias=False, dtype=dtype)), self.add(BatchNorm(32, 1e-3)))
        self.blocks = []
        cin = 32
        for t, c, n, s, k in self.CONFIG:
            for i in range(n):
                self.blocks.append(self.add(_MBConv(cin, c, k, s if i == 0 else 1, t, dtype=dtype)))
                cin = c
        self.head = (self.add(_ConvBN(cin, 1280, 1, act_fn=F.silu, dtype=dtype)), self.add(Dense(1280, num_classes)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.stem
        x = F.silu(bn(conv(x)))
        for block in self.blocks:
            x = block(x)
        top, dense = self.head
        return dense(top(x).mean(dim=(2, 3)).float())


def _sep_block(cell: Compact, x, filters: int, kernel: int, stride: int, dtype):
    """NASNet separable-conv block, made in ``cell``'s scope as Flax's
    function is: relu -> (depthwise conv, pointwise conv, BatchNorm) -> relu
    -> (depthwise conv, pointwise conv, BatchNorm)."""
    h = F.relu(x)
    for i, s in enumerate((stride, 1)):
        ch = h.shape[1]
        h = cell.child(Conv, ch, ch, kernel, s, groups=ch, bias=False, dtype=dtype)(h)
        h = cell.child(Conv, ch, filters, 1, bias=False, dtype=dtype)(h)
        h = cell.child(BatchNorm, filters, 1e-5)(h).to(dtype)
        if i == 0:
            h = F.relu(h)
    return h


def _shift_subsample(p):
    """The factorized reduction's two inputs: every second pixel, and every
    second pixel of the map shifted by one (pad bottom/right, crop
    top/left); a 1x1 stride-2 average is the subsample."""
    return p[..., ::2, ::2], F.pad(p, (0, 1, 0, 1))[..., 1:, 1:][..., ::2, ::2]


def _adjust(cell: Compact, p, ip, filters: int, dtype):
    """Match the previous hidden state ``p`` to ``ip``'s height and the
    cell's filter count (``flax_models._adjust``)."""
    if p is None:
        p = ip
    if p.shape[2] != ip.shape[2]:
        p1, p2 = _shift_subsample(F.relu(p))
        p1 = cell.child(Conv, p.shape[1], filters // 2, 1, bias=False, dtype=dtype)(p1)
        p2 = cell.child(Conv, p.shape[1], filters - filters // 2, 1, bias=False, dtype=dtype)(p2)
        p = cell.child(BatchNorm, filters, 1e-5)(torch.cat([p1, p2], dim=1)).to(dtype)
    elif p.shape[1] != filters:
        p = cell.child(Conv, p.shape[1], filters, 1, bias=False, dtype=dtype)(F.relu(p))
        p = cell.child(BatchNorm, filters, 1e-5)(p).to(dtype)
    return p


def _avg3(x, stride: int = 1):
    """Flax's 3x3 'SAME' average: zeros padded, counted in the mean."""
    (pt, pb), (pl, pr) = (same_padding(n, 3, stride) for n in x.shape[-2:])
    return F.avg_pool2d(F.pad(x, (pl, pr, pt, pb)), 3, stride)


def _max3(x, stride: int = 1):
    """Flax's 3x3 'SAME' max: -inf padded."""
    (pt, pb), (pl, pr) = (same_padding(n, 3, stride) for n in x.shape[-2:])
    return F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=float("-inf")), 3, stride)


class _NormalCellA(Compact):
    """NASNet-A normal cell (Zoph et al. 2018, fig. 4 left)."""

    def __init__(self, filters: int, dtype=torch.bfloat16):
        super().__init__()
        self.filters, self.dtype = filters, dtype

    def _forward(self, x, p):
        f, dt = self.filters, self.dtype
        p = _adjust(self, p, x, f, dt)
        h = self.child(Conv, x.shape[1], f, 1, bias=False, dtype=dt)(F.relu(x))
        h = self.child(BatchNorm, f, 1e-5)(h).to(dt)
        x1 = _sep_block(self, h, f, 5, 1, dt) + _sep_block(self, p, f, 3, 1, dt)
        x2 = _sep_block(self, p, f, 5, 1, dt) + _sep_block(self, p, f, 3, 1, dt)
        x3 = _avg3(h) + p
        x4 = _avg3(p) * 2  # two identical avg-pool branches
        x5 = _sep_block(self, h, f, 3, 1, dt) + h
        return torch.cat([p, x1, x2, x3, x4, x5], dim=1), x


class _ReductionCellA(Compact):
    """NASNet-A reduction cell (Zoph et al. 2018, fig. 4 right)."""

    def __init__(self, filters: int, dtype=torch.bfloat16):
        super().__init__()
        self.filters, self.dtype = filters, dtype

    def _forward(self, x, p):
        f, dt = self.filters, self.dtype
        p = _adjust(self, p, x, f, dt)
        h = self.child(Conv, x.shape[1], f, 1, bias=False, dtype=dt)(F.relu(x))
        h = self.child(BatchNorm, f, 1e-5)(h).to(dt)
        x1 = _sep_block(self, h, f, 5, 2, dt) + _sep_block(self, p, f, 7, 2, dt)
        x2 = _max3(h, 2) + _sep_block(self, p, f, 7, 2, dt)
        x3 = _avg3(h, 2) + _sep_block(self, p, f, 5, 2, dt)
        x4 = _avg3(x1) + x2
        x5 = _sep_block(self, x1, f, 3, 1, dt) + _max3(h, 2)
        return torch.cat([x2, x3, x4, x5], dim=1), x


class NASNetMobile(Compact):
    """NASNet-A (4 @ 1056) mobile config, 224x224 -> 1000 logits, with the
    paper's published cells (``flax_models.NASNetMobile``: 'SAME' convs,
    Flax's pooling, BatchNorm epsilon 1e-5); the registry's NASNetMobile is
    the checkpoint graph, :class:`~wicca_tpu_torch.models.nasnet_keras.NASNetMobileKeras`."""

    def __init__(self, num_classes: int = 1000, penultimate_filters: int = 1056, cells_per_stack: int = 4,
                 stem_filters: int = 32, dtype=torch.bfloat16, image_size=(224, 224)):
        super().__init__()
        self.num_classes, self.penultimate_filters = num_classes, penultimate_filters
        self.cells_per_stack, self.stem_filters, self.dtype = cells_per_stack, stem_filters, dtype
        self._build(image_size)

    def _forward(self, x):
        f, dt = self.penultimate_filters // 24, self.dtype  # 44 for mobile
        x = self.child(Conv, 3, self.stem_filters, 3, 2, bias=False, dtype=dt)(x.to(dt))
        x = self.child(BatchNorm, self.stem_filters, 1e-5)(x).to(dt)
        p = None
        x, p = self.child(_ReductionCellA, max(1, f // 4), dt)(x, p)
        x, p = self.child(_ReductionCellA, max(1, f // 2), dt)(x, p)
        for mult in (1, 2, 4):
            if mult > 1:
                x, p = self.child(_ReductionCellA, f * mult, dt)(x, p)
            for _ in range(self.cells_per_stack):
                x, p = self.child(_NormalCellA, f * mult, dt)(x, p)
        x = F.relu(x).mean(dim=(2, 3)).float()
        return self.child(Dense, x.shape[1], self.num_classes)(x)


class VGG(_Named):
    """VGG-16/19 (Simonyan & Zisserman 2014), 224x224 -> 1000 logits. The
    first dense layer's width follows ``image_size``."""

    BLOCKS16: Sequence[tuple[int, int]] = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
    BLOCKS19: Sequence[tuple[int, int]] = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16, blocks=BLOCKS16, image_size=(224, 224)):
        super().__init__()
        self.blocks = []
        cin = 3
        for feat, reps in blocks:
            self.blocks.append([self.add(Conv(cin if r == 0 else feat, feat, 3, dtype=dtype)) for r in range(reps)])
            cin = feat
        h, w = image_size
        for _ in blocks:
            h, w = h // 2, w // 2
        self.fc = [self.add(Dense(h * w * cin, 4096)), self.add(Dense(4096, 4096)), self.add(Dense(4096, num_classes))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for convs in self.blocks:
            for conv in convs:
                x = F.relu(conv(x))
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()  # Flax flattens NHWC
        x = F.relu(self.fc[0](x))
        x = F.relu(self.fc[1](x))
        return self.fc[2](x)


def VGG16(image_size=(224, 224), **kw) -> VGG:
    return VGG(blocks=VGG.BLOCKS16, image_size=image_size, **kw)


def VGG19(image_size=(224, 224), **kw) -> VGG:
    return VGG(blocks=VGG.BLOCKS19, image_size=image_size, **kw)


class _DenseBlockLayer(_Named):
    def __init__(self, cin: int, growth: int, dtype=torch.bfloat16):
        super().__init__()
        self.parts = (self.add(BatchNorm(cin, _RESNET_EPS)),
                      self.add(Conv(cin, 4 * growth, 1, bias=False, dtype=dtype)),
                      self.add(BatchNorm(4 * growth, _RESNET_EPS)),
                      self.add(Conv(4 * growth, growth, 3, bias=False, dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn0, conv0, bn1, conv1 = self.parts
        h = conv0(F.relu(bn0(x)))
        h = conv1(F.relu(bn1(h)))
        return torch.cat([x, h.to(x.dtype)], dim=1)


class DenseNet121(_Named):
    """DenseNet-121 (Huang et al. 2017), 224x224 -> 1000 logits (explicit
    (3, 3) stem pad and (1, 1) pool pad, BN eps 1.001e-5)."""

    STAGE_LAYERS: Sequence[int] = (6, 12, 24, 16)

    def __init__(self, num_classes: int = 1000, growth: int = 32, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = (self.add(Conv(3, 64, 7, 2, bias=False, padding=((3, 3), (3, 3)), dtype=dtype)),
                     self.add(BatchNorm(64, _RESNET_EPS)))
        self.stages = []
        c = 64
        for si, layers in enumerate(self.STAGE_LAYERS):
            block = []
            for _ in range(layers):
                block.append(self.add(_DenseBlockLayer(c, growth, dtype=dtype)))
                c += growth
            trans = None
            if si != len(self.STAGE_LAYERS) - 1:
                trans = (self.add(BatchNorm(c, _RESNET_EPS)), self.add(Conv(c, c // 2, 1, bias=False, dtype=dtype)))
                c //= 2
            self.stages.append((block, trans))
        self.head = (self.add(BatchNorm(c, _RESNET_EPS)), self.add(Dense(c, num_classes)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.stem
        x = F.relu(bn(conv(x))).to(self.dtype)
        x = F.max_pool2d(x, 3, 2, 1)
        for block, trans in self.stages:
            for layer in block:
                x = layer(x)
            if trans is not None:
                bn, conv = trans
                x = F.avg_pool2d(conv(F.relu(bn(x))), 2, 2)
        bn, dense = self.head
        return dense(F.relu(bn(x)).mean(dim=(2, 3)))


class _TransformerBlock(_Named):
    """Pre-LN transformer encoder block (ViT, Dosovitskiy et al. 2021 §3.1)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.parts = (self.add(LayerNorm(dim)), self.add(MultiHeadDotProductAttention(dim, heads, dtype)),
                      self.add(LayerNorm(dim)), self.add(Dense(dim, dim * mlp_ratio, dtype=dtype)),
                      self.add(Dense(dim * mlp_ratio, dim, dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ln0, attn, ln1, fc0, fc1 = self.parts
        x = x + attn(ln0(x).to(self.dtype)).float()
        y = F.gelu(fc0(ln1(x).to(self.dtype)), approximate="tanh")
        return x + fc1(y).float()


class ViT(_Named):
    """Vision Transformer (Dosovitskiy et al. 2021): a strided-conv patch
    embedding, a class token and learned position embeddings (their count
    follows ``image_size``), a pre-LN encoder with a float32 residual stream."""

    def __init__(self, num_classes: int = 1000, patch: int = 16, dim: int = 384, depth: int = 12, heads: int = 6,
                 dtype=torch.bfloat16, image_size=(224, 224)):
        super().__init__()
        self.dim = dim
        self.patch_embed = self.add(Conv(3, dim, patch, patch, dtype=dtype), "patch_embed")
        tokens = 1 + -(-image_size[0] // patch) * -(-image_size[1] // patch)  # SAME padding
        self.cls = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, dim))
        self.blocks = [self.add(_TransformerBlock(dim, heads, dtype=dtype)) for _ in range(depth)]
        self.head = (self.add(LayerNorm(dim)), self.add(Dense(dim, num_classes)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.patch_embed(x).flatten(2).transpose(1, 2).float()  # tokens in row-major (h, w) order
        x = torch.cat([self.cls.expand(b, 1, self.dim), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        ln, dense = self.head
        return dense(ln(x)[:, 0])


def ViTS16(image_size=(224, 224), **kw) -> ViT:
    """ViT-Small/16 (22M params)."""
    return ViT(dim=384, depth=12, heads=6, image_size=image_size, **kw)


def ViTTiny16(image_size=(224, 224), **kw) -> ViT:
    """ViT-Tiny/16 (5.7M params)."""
    return ViT(dim=192, depth=12, heads=3, image_size=image_size, **kw)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of a zoo model from ``generator``, by
    the Flax initializers' rules: LeCun-normal (truncated) kernels, zero
    biases, BatchNorm/LayerNorm scale 1 and bias 0, running statistics 0 and
    1, ViT's class token 0 and position embedding normal(0.02). The values
    differ from JAX's init of the same seed."""
    for m in model.modules():
        if isinstance(m, (Conv, Dense)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (BatchNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, ViT):
            m.cls.zero_()
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model
