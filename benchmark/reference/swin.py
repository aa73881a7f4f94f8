"""Plain Swin Transformer (Liu et al. 2021, arXiv:2103.14030, sections 3.1-3.2
and Table 1; the official ``swin_large_patch4_window12_384``) forward in
float32 PyTorch.

The network, from the configuration's ``patch_size``, ``embed_dim``,
``depths``, ``num_heads``, ``window_size``, ``mlp_ratio``, ``num_classes``
and ``input_size``:

* patch embedding: each ``patch x patch`` patch's pixels (channel, row,
  column) times a (C, 3 patch**2) matrix plus a bias, the tokens in
  row-major order, then LayerNorm; no absolute position embedding;
* stage s (a token grid of h x w = input / patch / 2**s, width C 2**s):
  blocks of ``x + WA(LN(x))`` then ``x + fc2(GELU(fc1(LN(x))))`` (exact
  GELU, hidden width ``mlp_ratio`` times the width). The stage's window M
  is ``min(window_size, h, w)``; where it is the grid's shorter side no
  block shifts, else the odd blocks shift by ``window_size // 2``;
* WA, with shift s: the window at (wy, wx) holds the tokens of the grid
  rolled by -s on both axes, token (i, j) of it being the grid's token
  ((wy M + i + s) mod h, (wx M + j + s) mod w); per head (width
  ``head_dim``), softmax(q k^T / sqrt(head_dim) + B + mask) v, where q, k,
  v come from one (3C, C) map with a bias, B[i, j] = table[(dy + M - 1)
  (2M - 1) + dx + M - 1] for (dy, dx) = position(i) - position(j), and,
  where s > 0, mask[i, j] = -100 between tokens whose region differs (a
  rolled coordinate y lies in region 0 below h - M, 1 below h - s, else 2;
  the region of a token is 3 region(y) + region(x)); then a (C, C) map with
  a bias, and each token back to where it was taken from;
* patch merging after every stage but the last: the 2 x 2 neighbours of
  each token pair (row 2a + dy, column 2b + dx) concatenated in the order
  (dy, dx) = (0, 0), (1, 0), (0, 1), (1, 1), LayerNorm(4C), a (2C, 4C) map
  without bias;
* LayerNorm, the mean over tokens, a dense head.

LayerNorm is ``(x - mean) / sqrt(var + 1e-5) * scale + offset`` with the
biased variance. Weights are a flat list in the order the forward uses
them (:func:`weight_shapes`). The forward runs with TF32 off; ``fp8=True``
rounds the inputs and weights of every product (the patch matrix, each
linear map, q, k, the attention weights, v) to float8 e4m3 with a
per-tensor scale first: the control. Departure from the published model:
none in the forward; the harness resizes with INTER_AREA, not bicubic,
which the program and this reference share.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

MASKED = -100.0
LN_EPS = 1e-5
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class Stage:
    h: int
    w: int
    dim: int
    heads: int
    window: int
    shift: int  # of the odd blocks
    depth: int
    merge: bool


def stages(config: dict, h: int, w: int) -> list[Stage]:
    """The stages at an ``h x w`` input; raises ``ValueError`` where the
    windows do not tile a stage's grid."""
    p, big = config["patch_size"], config["window_size"]
    depths = config["depths"]
    if h % p or w % p:
        raise ValueError(f"{h}x{w} is not a whole number of {p}x{p} patches")
    h, w, out = h // p, w // p, []
    for s, (depth, heads) in enumerate(zip(depths, config["num_heads"])):
        m = min(big, h, w)
        merge = s < len(depths) - 1
        if h % m or w % m or (merge and (h % 2 or w % 2)):
            raise ValueError(f"stage {s}'s {h}x{w} tokens are not tiled by {m}x{m} windows")
        out.append(Stage(h, w, config["embed_dim"] << s, heads, m, 0 if min(h, w) <= big else big // 2, depth, merge))
        h, w = h // 2, w // 2
    return out


def _specs(config: dict) -> list[tuple[tuple, str, float]]:
    """(shape, draw, scale) of each weight, in order: a 'normal' draw times
    the scale, or a 'uniform' one in [0.8, 1.2]."""
    c, p = config["embed_dim"], config["patch_size"]

    def norm(d):
        return [((d,), "uniform", 1.0), ((d,), "normal", 0.05)]

    def linear(fout, fin, bias=True):
        return [((fout, fin), "normal", 1 / math.sqrt(fin))] + ([((fout,), "normal", 0.01)] if bias else [])

    specs = [((c, 3, p, p), "normal", 1 / math.sqrt(3 * p * p)), ((c,), "normal", 0.02)] + norm(c)
    for st in stages(config, *config["input_size"]):
        d = st.dim
        hidden = int(config["mlp_ratio"] * d)
        for _ in range(st.depth):
            specs += norm(d) + [(((2 * st.window - 1) ** 2, st.heads), "normal", 1.0)]
            specs += linear(3 * d, d) + linear(d, d) + norm(d) + linear(hidden, d) + linear(d, hidden)
        if st.merge:
            specs += norm(4 * d) + linear(2 * d, 4 * d, bias=False)
    last = c << (len(config["depths"]) - 1)
    return specs + norm(last) + linear(config["num_classes"], last)


def weight_shapes(config: dict) -> list[tuple]:
    """Shapes of the flat weight list, in order: the patch matrix (C, 3, p,
    p) and its bias, a LayerNorm (scale, offset); per block LayerNorm, the
    bias table, qkv (matrix, bias), proj, LayerNorm, fc1, fc2; per merging
    LayerNorm(4C) and its (2C, 4C) matrix; LayerNorm and the head."""
    return [shape for shape, _, _ in _specs(config)]


def make_weights(config: dict, seed: int, device) -> list[torch.Tensor]:
    """Seeded weights: linear maps and the patch matrix normal with LeCun's
    scale, their biases normal(0, 0.01) (the patch's 0.02), LayerNorm
    scales uniform in [0.8, 1.2] and offsets normal(0, 0.05), the relative
    position bias tables normal(0, 1), far from zero so that the bias path
    shows. Two draws on ``device``, sliced per leaf."""
    specs = _specs(config)
    sizes = [math.prod(shape) for shape, _, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device) * 0.4 + 0.8
    out, off = [], 0
    for (shape, kind, scale), n in zip(specs, sizes):
        src = normal if kind == "normal" else uniform
        out.append((src[off : off + n] * scale).reshape(shape))
        off += n
    return out


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB pixels -> the published normalisation in float32, in
    the program's order: / 255, then (x - mean) / std."""
    x = x.to(torch.float32) / 255.0
    mean = torch.tensor(MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def flops(config: dict, h: int, w: int) -> int:
    """Operations of one forward at ``h x w``: 2 x the multiply-adds of the
    patch matrix, every linear map, q k^T and the attention's product with
    v, from the shapes (norms, softmax, GELU and the mean not counted)."""
    p, c = config["patch_size"], config["embed_dim"]
    macs = (h // p) * (w // p) * c * 3 * p * p
    for st in stages(config, h, w):
        t, d, n = st.h * st.w, st.dim, st.window**2
        hidden = int(config["mlp_ratio"] * d)
        macs += st.depth * (t * d * 3 * d + 2 * t * n * d + t * d * d + 2 * t * d * hidden)
        if st.merge:
            macs += (t // 4) * 4 * d * 2 * d
    return 2 * (macs + (c << (len(config["depths"]) - 1)) * config["num_classes"])


def relative_index(m: int) -> torch.Tensor:
    """(m*m, m*m) index into a ((2m - 1)**2, heads) table."""
    i = torch.arange(m * m)
    dy = (i // m)[:, None] - (i // m)[None, :]
    dx = (i % m)[:, None] - (i % m)[None, :]
    return (dy + m - 1) * (2 * m - 1) + dx + m - 1


def _region(y: torch.Tensor, n: int, m: int, s: int) -> torch.Tensor:
    return (y >= n - m).long() + (y >= n - s).long()


def window_tokens(h: int, w: int, m: int, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(windows, m*m) flat grid index of each window's tokens (rolled by
    -s), and (windows, m*m, m*m) float32 shift mask (zeros where s = 0)."""
    wy, wx, i, j = torch.meshgrid(torch.arange(h // m), torch.arange(w // m), torch.arange(m), torch.arange(m),
                                  indexing="ij")
    y, x = (wy * m + i).reshape(-1, m * m), (wx * m + j).reshape(-1, m * m)  # rolled coordinates
    index = ((y + s) % h) * w + (x + s) % w
    mask = torch.zeros(index.shape[0], m * m, m * m)
    if s:
        region = 3 * _region(y, h, m, s) + _region(x, w, m, s)
        mask[region[:, :, None] != region[:, None, :]] = MASKED
    return index, mask


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _layer_norm(x, g, b):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * g + b


def forward(x: torch.Tensor, weights: list[torch.Tensor], config: dict, fp8: bool = False) -> torch.Tensor:
    """``x``: NHWC float32 (preprocessed) -> float32 logits."""
    q8 = _fp8 if fp8 else (lambda t: t)
    it = iter(w.float() for w in weights)
    b, hh, ww, _ = x.shape
    p = config["patch_size"]
    with _no_tf32():
        wgt, bias = next(it), next(it)
        patches = x.float().reshape(b, hh // p, p, ww // p, p, 3).permute(0, 1, 3, 5, 2, 4)
        t = q8(patches.reshape(b, -1, 3 * p * p)) @ q8(wgt.reshape(wgt.shape[0], -1)).T + bias
        t = _layer_norm(t, next(it), next(it))
        for st in stages(config, hh, ww):
            heads, d = st.heads, st.dim
            hd = d // heads
            for k in range(st.depth):
                g1, b1, table, wqkv, bqkv, wproj, bproj, g2, b2, w1, c1, w2, c2 = (next(it) for _ in range(13))
                shift = st.shift if k % 2 else 0
                index, mask = window_tokens(st.h, st.w, st.window, shift)
                index, mask = index.to(t.device), mask.to(t.device)
                n = st.window**2
                win = _layer_norm(t, g1, b1)[:, index]  # (B, windows, N, d)
                qkv = (q8(win) @ q8(wqkv).T + bqkv).reshape(b, -1, n, 3, heads, hd)
                qh, kh, vh = (qkv[:, :, :, r].transpose(2, 3) for r in range(3))  # (B, windows, heads, N, hd)
                scores = q8(qh / math.sqrt(hd)) @ q8(kh).transpose(-1, -2)
                bias_hnn = table[relative_index(st.window).to(t.device)].permute(2, 0, 1)
                attn = torch.softmax(scores + bias_hnn + mask[:, None], dim=-1)
                out = (q8(attn) @ q8(vh)).transpose(2, 3).reshape(b, -1, n, d)
                out = q8(out) @ q8(wproj).T + bproj
                back = torch.empty_like(t)
                back[:, index.reshape(-1)] = out.reshape(b, -1, d)
                t = t + back
                y = q8(_layer_norm(t, g2, b2)) @ q8(w1).T + c1
                y = 0.5 * y * (1.0 + torch.erf(y / math.sqrt(2.0)))
                t = t + (q8(y) @ q8(w2).T + c2)
            if st.merge:
                g, bb, red = next(it), next(it), next(it)
                grid = t.reshape(b, st.h // 2, 2, st.w // 2, 2, d).permute(0, 1, 3, 4, 2, 5)  # (.., dx, dy, d)
                t = q8(_layer_norm(grid.reshape(b, -1, 4 * d), g, bb)) @ q8(red).T
        g, bb, wh, bh = next(it), next(it), next(it), next(it)
        return q8(_layer_norm(t, g, bb).mean(dim=1)) @ q8(wh).T + bh


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
