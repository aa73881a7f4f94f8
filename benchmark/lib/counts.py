"""Work counted from shapes: the bytes a codec roundtrip or an icon must
move and the operations a MobileNetV2 forward must do, whatever kernels
implement them."""

from __future__ import annotations

from benchmark.reference import mobilenetv2


def haar_roundtrip_bytes(c: int, h: int, w: int, levels: int, code_bytes: int = 1) -> int:
    """Least bytes of ``decode(encode(frame), emit_u8=True)`` on a uint8
    frame: the frame read once, the stream (codes of every detail band and
    the float32 LL) written once and read once, the uint8 reconstruction
    written once. Intermediates between fused passes are not counted."""
    codes = sum(3 * c * (h >> lvl) * (w >> lvl) for lvl in range(1, levels + 1)) * code_bytes
    ll = c * (h >> levels) * (w >> levels) * 4
    return c * h * w + 2 * (codes + ll) + c * h * w


def icon_bytes(c: int, h: int, w: int, depth: int) -> int:
    """Least bytes of one depth-``depth`` icon: the planes read once, the
    icon (``ceil`` of each side over ``2**depth``) written once."""
    unit = 1 << depth
    return c * h * w + c * (-(-h // unit)) * (-(-w // unit))


def mobilenetv2_flops(config: dict, h: int, w: int) -> int:
    """Operations of one MobileNetV2 forward at ``h x w``: 2 x the
    multiply-adds of every convolution and of the dense head, from the
    layer shapes (output size by SAME padding)."""
    macs = 0
    for unit in mobilenetv2.layers(config):
        for conv in (unit.convs if isinstance(unit, mobilenetv2.Block) else (unit,)):
            if isinstance(conv, mobilenetv2.Dense):
                macs += conv.cin * conv.cout
                continue
            h, w = -(-h // conv.stride), -(-w // conv.stride)
            macs += h * w * conv.cout * (conv.cin // conv.groups) * conv.k * conv.k
    return 2 * macs
