"""Plain MaxViT (Tu et al. 2022, "MaxViT: Multi-Axis Vision Transformer",
arXiv:2204.01697, sections 3.1-3.3 and Table 2's MaxViT-XL at 512 x 512;
the official google-research/maxvit release, timm's
``maxvit_xlarge_tf_512``) forward in float32 PyTorch.

The network, from the configuration's ``stem_width``, ``widths``,
``depths``, ``head_dim``, ``window_size``, ``expand_ratio``, ``se_ratio``,
``mlp_ratio``, ``bn_eps``, ``layer_norm_eps``, ``num_classes`` and
``input_size`` (x is B x C x H x W in the convolutions, its tokens B x H x
W x C, row-major, in the attention):

* stem: Conv3x3 stride 2 (3 -> stem, bias), BN, GELU, Conv3x3 stride 1
  (stem -> stem, bias);
* stage s (width C, depth D, a grid of h x w = input / 2**(s + 2)): D
  blocks, the first at stride 2; each block is MBConv, then block
  attention, then grid attention;
* MBConv(x; C_in -> C, stride t): y = BN0(x); y = GELU(BN1(Conv1x1(y;
  C_in -> E C, no bias))); y = GELU(BN2(DWConv3x3_t(y; E C, no bias)));
  y = y * sigmoid(Conv1x1(SiLU(Conv1x1(mean_hw(y); E C -> se C, bias));
  se C -> E C, bias)); y = Conv1x1(y; E C -> C, bias); the output is y +
  x where t = 1 and C_in = C, else y + Conv1x1(AvgPool2x2_t(x); C_in ->
  C, bias) (E the expansion, se the squeeze ratio);
* partition attention, P = min(window_size, h, w): x = x + PA(LN(x)),
  then x = x + fc2(GELU(fc1(LN(x)))) with hidden width ``mlp_ratio`` C.
  The block partition's window (a, b) holds the tokens (a P + i, b P +
  j); the grid partition's window (a, b) holds the tokens (i h/P + a, j
  w/P + b), for i, j < P. Per head of width ``head_dim``:
  softmax(q k^T / sqrt(head_dim) + B) v, where q, k and v come from one
  (3C, C) map with a bias and B[m, n] = table[(di + P - 1)(2P - 1) + dj +
  P - 1] for (di, dj) = (i_m - i_n, j_m - j_n), the tokens' coordinates
  in the window; then a (C, C) map with a bias, and each token goes back
  to its place;
* head: the mean over h x w, LN, tanh(Dense(C, C)), Dense(C, classes).

BN is ``(x - mean) / sqrt(var + bn_eps) * scale + offset`` with the
running statistics; LN ``(x - mean) / sqrt(var + layer_norm_eps) * scale +
offset`` with the biased variance; GELU ``0.5 y (1 + tanh(sqrt(2/pi) (y +
0.044715 y**3)))``; SiLU ``y sigmoid(y)``. Every convolution pads as
TensorFlow's ``SAME`` (``pad = max((ceil(n/s)-1)*s + k - n, 0)``, the
smaller half first).

Assumed, where the paper does not fix a detail and the official code was
not at hand: GELU in its tanh form (the TF release's); squeeze-excite
with SiLU, reducing to ``se_ratio`` of the block's output width; BatchNorm
epsilon 1e-3; the biases exactly as listed above; the pre-logits layer
with tanh. Departures: none in the forward; the harness resizes with
INTER_AREA, not the official bicubic resize, which the program and this
reference share. :func:`flops` gives 531.15 G multiply-adds at 512 x
512, 0.76% under the published 535.2 G, with each stage's first expansion
counted at its input's resolution, where it runs (at the strided
resolution it would be 4.1% under).

Weights are a flat list in the order of the program's state dict
(:func:`weight_shapes`). The forward runs with TF32 off; ``fp8=True``
rounds the inputs and weights of every product (each convolution and
linear map, q, k, the attention weights, v) to float8 e4m3 with a
per-tensor scale first: the control.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


BRANCH_GAIN = 0.1  # the variance gain of the maps that end a residual branch, against LeCun's 1
BIAS_SCALE = 0.01  # the standard deviation of the biases that are not 0


@dataclass(frozen=True)
class Stage:
    h: int
    w: int
    dim: int
    heads: int
    window: int
    depth: int


def stages(config: dict, h: int, w: int) -> list[Stage]:
    """The stages at an ``h x w`` input; raises ``ValueError`` where a
    halving meets an odd side or the partitions do not tile a grid."""
    big, out = config["window_size"], []
    for s in range(len(config["depths"]) + 1):
        if h % 2 or w % 2:
            raise ValueError(f"a {h}x{w} grid does not halve")
        h, w = h // 2, w // 2
        if s == 0:  # the stem
            continue
        p = min(big, h, w)
        if h % p or w % p:
            raise ValueError(f"stage {s - 1}'s {h}x{w} tokens are not tiled by {p}x{p} windows")
        dim = config["widths"][s - 1]
        out.append(Stage(h, w, dim, dim // config["head_dim"], p, config["depths"][s - 1]))
    return out


def _specs(config: dict) -> list[tuple[tuple, str, float]]:
    """(shape, draw, scale) of each weight, in order: 'normal' (a normal
    draw times the scale), 'centred' (the same with each output row's mean
    taken out), 'uniform' (in [0.8, 1.2]), 'zero', or 'bn_offset' (the
    offset that cancels its BatchNorm's shift, from the three statistics
    around it)."""

    def bn(d):
        return [((d,), "uniform", 1.0), ((d,), "bn_offset", 1.0), ((d,), "normal", 0.1), ((d,), "uniform", 1.0)]

    def ln(d):
        return [((d,), "uniform", 1.0), ((d,), "zero", 1.0)]

    def conv(cout, cin, k=1, groups=1, gain=1.0, bias="zero", draw="normal"):
        fan_in = cin // groups * k * k
        return [((cout, cin // groups, k, k), draw, math.sqrt(gain / fan_in))] + (
            [((cout,), bias, BIAS_SCALE)] if bias else [])

    def linear(fout, fin, gain=1.0, bias="zero", draw="normal"):
        return [((fout, fin), draw, math.sqrt(gain / fin)), ((fout,), bias, BIAS_SCALE)]

    stem, branch = config["stem_width"], BRANCH_GAIN
    specs = conv(stem, 3, 3) + bn(stem) + conv(stem, stem, 3, gain=2.0, draw="centred")
    cin = stem
    for st in stages(config, *config["input_size"]):
        c = st.dim
        mid, rd = config["expand_ratio"] * c, int(config["se_ratio"] * c)
        hidden = config["mlp_ratio"] * c
        for j in range(st.depth):
            cj = cin if j == 0 else c
            specs += bn(cj) + conv(mid, cj, bias=None) + bn(mid) + conv(mid, mid, 3, mid, 2.0, None, "centred")
            specs += bn(mid) + conv(rd, mid, gain=2.0, bias="normal") + conv(mid, rd, bias="normal", draw="centred")
            specs += conv(c, mid, gain=2.0 * branch, draw="centred")
            if j == 0:
                specs += conv(c, cj)
            for _ in ("block", "grid"):
                specs += ln(c) + [(((2 * st.window - 1) ** 2, st.heads), "normal", 1.0)]
                specs += linear(3 * c, c, bias="normal") + linear(c, c, branch, draw="centred") + ln(c)
                specs += linear(hidden, c) + linear(c, hidden, 2.0 * branch, draw="centred")
        cin = c
    return specs + ln(cin) + linear(cin, cin, bias="normal") + linear(config["num_classes"], cin, bias="normal")


def weight_shapes(config: dict) -> list[tuple]:
    """Shapes of the flat weight list, in order: the stem's two
    convolutions (weight, bias) around a BN (scale, offset, mean,
    variance); per block the MBConv's BN0, expansion, BN1, depthwise
    weight, BN2, the squeeze-excite's two (weight, bias), the projection,
    and in a stage's first block the shortcut; then for each of the block
    and grid attention LN, the bias table, qkv, proj, LN, fc1, fc2; the
    head's LN, pre-logits and classifier."""
    return [shape for shape, _, _ in _specs(config)]


def make_weights(config: dict, seed: int, device) -> list[torch.Tensor]:
    """Seeded weights, drawn so that the logits of different images differ
    by many times the program's rounding, with the stream of order 1
    through every block:

    * convolutions and linear maps normal with LeCun's scale (He's where a
      GELU output feeds them); the maps that end a residual branch (MBConv's
      projection, proj, fc2) at ``BRANCH_GAIN`` of that variance, so that
      72 residual adds leave the stream of order 1 (at 1.0 it grows some
      hundredfold over the 24 blocks, and bfloat16's rounding with it);
    * the maps that read a GELU's or a gate's output (the stem's second
      convolution, the depthwise kernels, squeeze-excite's expansion,
      MBConv's projection, proj, fc2) with each output row's mean taken out
      (its kernel sums to 0), and every BN's offset equal to ``scale *
      mean / sqrt(variance + eps)``, so that each BN only scales its
      channels; the biases of qkv, squeeze-excite, the pre-logits and the
      classifier normal(0, ``BIAS_SCALE``), every other bias and the LN
      offsets 0. So no branch adds a constant to the stream: the images
      (seeded textures of one kind) differ little in their spatial mean
      against such a constant, and with one the logits of every image of a
      folder come out nearly equal;
    * BN and LN scales and BN variances uniform in [0.8, 1.2], BN means
      normal(0, 0.1): a forward that leaves out the mean, the variance or
      the offset shifts its channels; the relative position bias tables
      normal(0, 1), far from zero so that the bias path shows;
    * every weight on bfloat16's grid (a value bfloat16 holds exactly), as
      a checkpoint kept in bfloat16 is, so that the program's cast of its
      weights rounds nothing and the comparison sees its arithmetic.

    Two draws on ``device``, sliced per leaf."""
    specs = _specs(config)
    sizes = [math.prod(shape) for shape, _, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device) * 0.4 + 0.8
    out, off = [], 0
    for (shape, kind, scale), n in zip(specs, sizes):
        t = ((uniform if kind == "uniform" else normal)[off : off + n] * scale).reshape(shape)
        if kind == "centred":
            t = t - t.flatten(1).mean(dim=1).reshape((-1,) + (1,) * (len(shape) - 1))
        elif kind in ("zero", "bn_offset"):
            t = torch.zeros_like(t)
        out.append(t)
        off += n
    for i, (_, kind, _) in enumerate(specs):
        if kind == "bn_offset":  # (scale, offset, mean, variance)
            out[i] = out[i - 1] * out[i + 1] / torch.sqrt(out[i + 2] + config["bn_eps"])
    return [t.to(torch.bfloat16).float() for t in out]


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB pixels -> [-1, 1] in float32 (the TF release's mean 0.5
    and std 0.5), in the program's order: / 127.5, then - 1."""
    return x.to(torch.float32) / 127.5 - 1.0


def flops(config: dict, h: int, w: int) -> int:
    """Operations of one forward at ``h x w``: 2 x the multiply-adds of
    every convolution (the depthwise and squeeze-excite ones too), every
    linear map, q k^T and the attention's product with v, from the shapes
    (norms, activations, pooling, softmax and the means not counted). A
    strided first MBConv expands at its input's resolution."""
    stem = config["stem_width"]
    hs, ws = h // 2, w // 2
    macs = hs * ws * stem * (3 * 9 + stem * 9)
    cin, t_in = stem, hs * ws
    for st in stages(config, h, w):
        c, t, n = st.dim, st.h * st.w, st.window**2
        mid, rd = config["expand_ratio"] * c, int(config["se_ratio"] * c)
        hidden = config["mlp_ratio"] * c
        for j in range(st.depth):
            cj, tj = (cin, t_in) if j == 0 else (c, t)
            macs += tj * cj * mid + t * mid * 9 + 2 * mid * rd + t * mid * c + (t * cj * c if j == 0 else 0)
            macs += 2 * (t * c * 3 * c + 2 * t * n * c + t * c * c + 2 * t * c * hidden)
        cin, t_in = c, t
    return 2 * (macs + cin * cin + cin * config["num_classes"])


def relative_index(m: int) -> torch.Tensor:
    """(m*m, m*m) index into a ((2m - 1)**2, heads) table."""
    i = torch.arange(m * m)
    di = (i // m)[:, None] - (i // m)[None, :]
    dj = (i % m)[:, None] - (i % m)[None, :]
    return (di + m - 1) * (2 * m - 1) + dj + m - 1


def window_tokens(h: int, w: int, p: int, partition: str) -> torch.Tensor:
    """(windows, p*p) flat grid index of each window's tokens, windows and
    tokens row-major: ``partition`` 'block' or 'grid'."""
    a, b, i, j = torch.meshgrid(torch.arange(h // p), torch.arange(w // p), torch.arange(p), torch.arange(p),
                                indexing="ij")
    if partition == "block":
        y, x = a * p + i, b * p + j
    else:  # "grid"
        y, x = i * (h // p) + a, j * (w // p) + b
    return (y * w + x).reshape(-1, p * p)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _gelu(y):
    return 0.5 * y * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (y + 0.044715 * y**3)))


def _layer_norm(x, g, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g + b


def forward(x: torch.Tensor, weights: list[torch.Tensor], config: dict, fp8: bool = False) -> torch.Tensor:
    """``x``: NHWC float32 (preprocessed) -> float32 logits."""
    q8 = _fp8 if fp8 else (lambda t: t)
    it = iter(w.float() for w in weights)
    bn_eps, ln_eps, hd = config["bn_eps"], config["layer_norm_eps"], config["head_dim"]
    b, hh, ww, _ = x.shape

    def take(n):
        return [next(it) for _ in range(n)]

    def conv(h, k=1, stride=1, groups=1, bias=True):
        wgt, c = next(it), (next(it) if bias else None)
        return F.conv2d(_same_pad(q8(h), k, stride), q8(wgt), c, stride, 0, 1, groups)

    def bn(h):
        g, o, m, v = take(4)
        return (h - m[:, None, None]) / torch.sqrt(v + bn_eps)[:, None, None] * g[:, None, None] + o[:, None, None]

    def mbconv(h, stride, first):
        y = conv(bn(h), bias=False)
        y = _gelu(bn(y))
        y = _gelu(bn(conv(y, 3, stride, y.shape[1], bias=False)))
        s = conv(y.mean(dim=(2, 3), keepdim=True))
        y = y * torch.sigmoid(conv(s * torch.sigmoid(s)))
        y = conv(y)
        if not first:
            return h + y
        return y + conv(F.avg_pool2d(h, stride, stride) if stride != 1 else h)

    def attention(t, st, partition):
        g1, b1, table, wqkv, bqkv, wproj, bproj, g2, b2, w1, c1, w2, c2 = take(13)
        index = window_tokens(st.h, st.w, st.window, partition).to(t.device)
        n, d, heads = st.window**2, st.dim, st.heads
        win = _layer_norm(t, g1, b1, ln_eps)[:, index]  # (B, windows, N, d)
        qkv = (q8(win) @ q8(wqkv).T + bqkv).reshape(b, -1, n, 3, heads, hd)
        qh, kh, vh = (qkv[:, :, :, r].transpose(2, 3) for r in range(3))  # (B, windows, heads, N, hd)
        scores = q8(qh / math.sqrt(hd)) @ q8(kh).transpose(-1, -2)
        bias = table[relative_index(st.window).to(t.device)].permute(2, 0, 1)
        attn = torch.softmax(scores + bias, dim=-1)
        out = (q8(attn) @ q8(vh)).transpose(2, 3).reshape(b, -1, n, d)
        out = q8(out) @ q8(wproj).T + bproj
        back = torch.empty_like(t)
        back[:, index.reshape(-1)] = out.reshape(b, -1, d)
        t = t + back
        y = _gelu(q8(_layer_norm(t, g2, b2, ln_eps)) @ q8(w1).T + c1)
        return t + (q8(y) @ q8(w2).T + c2)

    with _no_tf32():
        h = x.permute(0, 3, 1, 2).float()
        h = conv(_gelu(bn(conv(h, 3, 2))), 3)
        for st in stages(config, hh, ww):
            for j in range(st.depth):
                h = mbconv(h, 2 if j == 0 else 1, j == 0)
                t = h.permute(0, 2, 3, 1).reshape(b, st.h * st.w, st.dim)
                t = attention(attention(t, st, "block"), st, "grid")
                h = t.reshape(b, st.h, st.w, st.dim).permute(0, 3, 1, 2)
        g, o, wp, bp, wh, bh = take(6)
        pooled = _layer_norm(h.mean(dim=(2, 3)), g, o, ln_eps)
        return q8(torch.tanh(q8(pooled) @ q8(wp).T + bp)) @ q8(wh).T + bh


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
