"""Checkpoint-faithful NASNet-A Mobile, the registry's and the converter's
graph (counterpart of ``wicca_tpu/models/nasnet_keras.py``).

The hosted ImageNet checkpoint is laid out for keras/applications/nasnet.py's
functional graph: stem reduction cells, factorized ``adjust`` blocks with the
shifted second average-pool path, the asymmetric ``correct_pad`` on every
stride-2 separable conv, and TF average pooling that leaves padding out of
the mean. Every parameterized layer takes its Keras layer name
(``stem_conv1``, ``separable_conv_1_normal_left1_0`` with its depthwise
``Conv_0`` and pointwise ``Conv_1``, ``adjust_bn_stem_2``, ``predictions``),
so a Flax tree of the JAX module carries across by
:mod:`wicca_tpu_torch.models.interop` and the converter's NASNet schema is a
walk over the same names. BatchNorm epsilon 1e-3, in float32, recast to the
compute dtype after it.

NASNet-A (4 @ 1056) mobile config: penultimate_filters=1056 (cell filters
44), num_blocks=4, stem 32 (Zoph et al. 2018, arXiv:1707.07012; graph per
keras.applications).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wicca_tpu_torch.models.nets import BatchNorm, Compact, Conv, Dense, _shift_subsample

_VALID = ((0, 0), (0, 0))


def _correct_pad(h: int, w: int, k: int) -> tuple[int, int, int, int]:
    """Keras ``imagenet_utils.correct_pad`` as ``F.pad``'s (left, right, top,
    bottom): asymmetric zeros, so that a stride-2 VALID conv halves an odd
    size as 'same' would."""
    c = k // 2
    return c - (1 - w % 2), c, c - (1 - h % 2), c


def _avg_tf(x, k: int, s: int, same: bool):
    """TF/Keras ``AveragePooling2D``: padded cells left out of the mean
    ('same' here is always 3x3 at stride 1)."""
    return F.avg_pool2d(x, k, s, k // 2 if same else 0, count_include_pad=False)


class _SepConv(Compact):
    """Keras ``SeparableConv2D``: depthwise ``Conv_0`` + pointwise
    ``Conv_1``, no bias; a stride-2 caller pads outside (Keras's
    ``ZeroPadding2D``)."""

    def __init__(self, filters: int, kernel: int, stride: int, padding, dtype):
        super().__init__()
        self.filters, self.kernel, self.stride, self.padding, self.dtype = filters, kernel, stride, padding, dtype

    def _forward(self, x):
        cin = x.shape[1]
        x = self.child(Conv, cin, cin, self.kernel, self.stride, groups=cin, bias=False, padding=self.padding,
                       dtype=self.dtype, name="Conv_0")(x)
        return self.child(Conv, cin, self.filters, 1, bias=False, dtype=self.dtype, name="Conv_1")(x)


class NASNetMobileKeras(Compact):
    """NASNet-A mobile with the hosted checkpoint's layer graph and names."""

    def __init__(self, num_classes: int = 1000, penultimate_filters: int = 1056, num_blocks: int = 4,
                 stem_filters: int = 32, dtype=torch.bfloat16, image_size=(224, 224)):
        super().__init__()
        self.num_classes, self.penultimate_filters, self.num_blocks = num_classes, penultimate_filters, num_blocks
        self.stem_filters, self.dtype = stem_filters, dtype
        self._build(image_size)

    def _bn(self, x, name: str):
        return self.child(BatchNorm, x.shape[1], 1e-3, name=name)(x).to(self.dtype)

    def _conv1(self, x, filters: int, name: str):
        return self.child(Conv, x.shape[1], filters, 1, bias=False, dtype=self.dtype, name=name)(x)

    def _sep_block(self, x, filters: int, kernel: int, stride: int, block_id: str):
        """relu -> sepconv -> bn -> relu -> sepconv -> bn (keras
        ``_separable_conv_block``)."""
        x = F.relu(x)
        pad = "SAME"
        if stride == 2:
            x = F.pad(x, _correct_pad(x.shape[2], x.shape[3], kernel))
            pad = _VALID
        x = self.child(_SepConv, filters, kernel, stride, pad, self.dtype, name=f"separable_conv_1_{block_id}")(x)
        x = F.relu(self._bn(x, f"separable_conv_1_bn_{block_id}"))
        x = self.child(_SepConv, filters, kernel, 1, "SAME", self.dtype, name=f"separable_conv_2_{block_id}")(x)
        return self._bn(x, f"separable_conv_2_bn_{block_id}")

    def _adjust(self, p, ip, filters: int, block_id: str):
        """keras ``_adjust_block``: match p's geometry and channels to ip."""
        if p is None:
            return ip
        if p.shape[2] != ip.shape[2]:  # spatial mismatch -> factorized reduction
            p1, p2 = _shift_subsample(F.relu(p))
            p1 = self._conv1(p1, filters // 2, f"adjust_conv_1_{block_id}")
            p2 = self._conv1(p2, filters // 2, f"adjust_conv_2_{block_id}")
            return self._bn(torch.cat([p1, p2], dim=1), f"adjust_bn_{block_id}")
        if p.shape[1] != filters:  # channel mismatch -> 1x1 projection
            p = self._conv1(F.relu(p), filters, f"adjust_conv_projection_{block_id}")
            return self._bn(p, f"adjust_bn_{block_id}")
        return p

    def _normal_cell(self, ip, p, filters: int, block_id: str):
        p = self._adjust(p, ip, filters, block_id)
        h = self._conv1(F.relu(ip), filters, f"normal_conv_1_{block_id}")
        h = self._bn(h, f"normal_bn_1_{block_id}")
        x1 = (self._sep_block(h, filters, 5, 1, f"normal_left1_{block_id}")
              + self._sep_block(p, filters, 3, 1, f"normal_right1_{block_id}"))
        x2 = (self._sep_block(p, filters, 5, 1, f"normal_left2_{block_id}")
              + self._sep_block(p, filters, 3, 1, f"normal_right2_{block_id}"))
        x3 = _avg_tf(h, 3, 1, True) + p
        x4 = _avg_tf(p, 3, 1, True) + _avg_tf(p, 3, 1, True)
        x5 = self._sep_block(h, filters, 3, 1, f"normal_left5_{block_id}") + h
        return torch.cat([p, x1, x2, x3, x4, x5], dim=1), ip

    def _reduction_cell(self, ip, p, filters: int, block_id: str):
        p = self._adjust(p, ip, filters, block_id)
        h = self._conv1(F.relu(ip), filters, f"reduction_conv_1_{block_id}")
        h = self._bn(h, f"reduction_bn_1_{block_id}")
        h3 = F.pad(h, _correct_pad(h.shape[2], h.shape[3], 3))  # max pooling is VALID on these zeros
        x1 = (self._sep_block(h, filters, 5, 2, f"reduction_left1_{block_id}")
              + self._sep_block(p, filters, 7, 2, f"reduction_right1_{block_id}"))
        x2 = F.max_pool2d(h3, 3, 2) + self._sep_block(p, filters, 7, 2, f"reduction_right2_{block_id}")
        x3 = _avg_tf(h3, 3, 2, False) + self._sep_block(p, filters, 5, 2, f"reduction_right3_{block_id}")
        x4 = _avg_tf(x1, 3, 1, True) + x2
        x5 = self._sep_block(x1, filters, 3, 1, f"reduction_left4_{block_id}") + F.max_pool2d(h3, 3, 2)
        return torch.cat([x2, x3, x4, x5], dim=1), ip

    def _forward(self, x):
        filters, nb = self.penultimate_filters // 24, self.num_blocks  # 44 for mobile
        x = self.child(Conv, 3, self.stem_filters, 3, 2, bias=False, padding=_VALID, dtype=self.dtype,
                       name="stem_conv1")(x.to(self.dtype))
        x = self._bn(x, "stem_bn1")
        p = None
        x, p = self._reduction_cell(x, p, filters // 4, "stem_1")
        x, p = self._reduction_cell(x, p, filters // 2, "stem_2")
        for i in range(nb):
            x, p = self._normal_cell(x, p, filters, f"{i}")
        x, p = self._reduction_cell(x, p, filters * 2, f"reduce_{nb}")
        for i in range(nb):
            x, p = self._normal_cell(x, p, filters * 2, f"{nb + i + 1}")
        x, p = self._reduction_cell(x, p, filters * 4, f"reduce_{2 * nb}")
        for i in range(nb):
            x, p = self._normal_cell(x, p, filters * 4, f"{2 * nb + i + 1}")
        x = F.relu(x).mean(dim=(2, 3)).float()
        return self.child(Dense, x.shape[1], self.num_classes, name="predictions")(x)
