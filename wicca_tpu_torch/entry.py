"""The flagship forward and the multi-rank dry run (counterparts of
``__graft_entry__.entry()`` and ``dryrun_multichip``).

``entry()``: a planar uint8 batch -> its depth-2 Haar icon (the reference's
block-mean LL chain) -> bilinear resize to 224x224 -> [-1, 1] -> MobileNetV2
logits (width 1.0, bf16, 1000 classes).

    forward, (model, images) = entry()
    logits = forward(model, images)   # (2, 1000) float32

``dryrun_multichip(n)``: one step of each parallel path over a world of
``n`` ranks (:func:`wicca_tpu_torch.parallel.launch.run_world`) at small
shapes: the spatially tiled codec with halo exchange, the per-shard pass
kernels (Haar on K2/K3, ``haar_int`` on K6/K7), a depth-5 lossless mesh
roundtrip through the container and its random access, a data-parallel
training step, and tp, pp and ep against their oracles.

The model's weights come from ``nets.init_weights`` with a
``torch.Generator`` seeded 0 (the values differ from the JAX entry's
``jax.random.PRNGKey(0)`` init). It runs on CUDA unless the caller passes
``device='cpu'``; with no card and no explicit CPU device it raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from wicca_tpu_torch._device import as_tensor, host_data_device
from wicca_tpu_torch.core.haar import block_mean_ll
from wicca_tpu_torch.core.pad import pad_to_multiple
from wicca_tpu_torch.models import nets

INPUT = (224, 224)


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) uint8 -> the model's (B, 3, 224, 224) float32 input:
    pad to a multiple of 4, the depth-2 block-mean LL, a bilinear resize
    with half-pixel centres (``jax.image.resize(..., 'bilinear')`` on this
    upsample), then ``/127.5 - 1``."""
    icon = block_mean_ll(pad_to_multiple(images_u8, 4).to(torch.float32), 2)
    icon = F.interpolate(icon, size=INPUT, mode="bilinear", align_corners=False, antialias=False)
    return icon / 127.5 - 1.0


def entry(device=None):
    """``(forward, (model, example_images))``: ``forward(model, images_u8)``
    runs :func:`preprocess` and the model on the model's device (numpy
    images go there) and returns float32 logits."""
    dev = host_data_device(device)
    model = nets.init_weights(nets.MobileNetV2(), torch.Generator().manual_seed(0)).eval().to(dev)

    def forward(model, images_u8):
        x = as_tensor(images_u8, next(model.parameters()).device)
        with torch.inference_mode():
            return model(preprocess(x))

    example_images = np.zeros((2, 3, 256, 256), dtype=np.uint8)
    return forward, (model, example_images)


def _mesh_shape(n: int) -> tuple[int, int, int]:
    if n >= 8:
        return n // 4, 2, 2
    if n == 4:
        return 1, 2, 2
    if n == 2:
        return 1, 1, 2
    return 1, 1, 1


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _dryrun_rank(n: int, device_type: str) -> dict:
    """One rank of :func:`dryrun_multichip` (a fresh process, so its launch
    counters start at 0); every check raises."""
    from wicca_tpu_torch.codec import decode_at_level, decode_region, deserialize, encode, fetch_stream, serialize
    from wicca_tpu_torch.core.metrics import psnr
    from wicca_tpu_torch.core.quant import QuantSpec
    from wicca_tpu_torch.harness.train import train_step
    from wicca_tpu_torch.ops import dwt53_cuda, dwt_cuda
    from wicca_tpu_torch.parallel import gather, make_mesh, tiled_decode, tiled_encode
    from wicca_tpu_torch.parallel import model_parallel as mp
    from wicca_tpu_torch.parallel.mesh import DATA_AXIS, axis_index, mesh_device

    data, ty, tx = _mesh_shape(n)
    mesh = make_mesh(data, ty, tx, device_type=device_type)
    dev = mesh_device(mesh)
    levels, spec = 2, QuantSpec(base_step=1.0)
    out = {}

    # the spatially tiled codec: a wide wavelet, so a halo at every lifting step
    h, w = ty * (1 << levels) * 8, tx * (1 << levels) * 32
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, h, w), dtype=np.uint8)).to(dev)
    rec = gather(tiled_decode(tiled_encode(img, levels, spec, "bior4.4", mesh=mesh), mesh=mesh))
    out["bior44_psnr_db"] = float(psnr(rec, img.to(torch.float32)))
    _check(out["bior44_psnr_db"] > 20.0, f"tiled codec roundtrip PSNR suspicious: {out['bior44_psnr_db']}")

    # the per-shard pass kernels: haar and haar_int are pair-local, so each
    # rank transforms its block and the stream is the single-device one (the
    # plain twins on the CPU hold it bit for bit)
    h5, w5 = ty * 64, tx * 128
    img5 = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, h5, w5), dtype=np.uint8)).to(dev)
    for wavelet in ("haar", "haar_int"):
        stream = tiled_encode(img5, levels, spec, wavelet, mesh=mesh)
        rec = gather(tiled_decode(stream, mesh=mesh, emit_u8=True))
        want = encode(img5.cpu(), levels, spec, wavelet=wavelet)
        _check(torch.equal(gather(stream.ll).cpu(), want.ll) and all(
            torch.equal(gather(a).cpu(), b) for got, exp in zip(stream.details, want.details) for a, b in zip(got, exp)),
            f"{wavelet} mesh stream differs from the single-device stream")
        if wavelet == "haar_int":
            _check(torch.equal(rec, img5), "haar_int mesh roundtrip not lossless")
        else:
            out["haar_psnr_db"] = float(psnr(rec, img5.to(torch.float32)))
            _check(out["haar_psnr_db"] > 40.0, f"haar mesh roundtrip PSNR suspicious: {out['haar_psnr_db']}")

    # depth-5 lossless 5/3 on the mesh, the container and random access
    stream5 = tiled_encode(img5, 5, spec, "legall5.3", mesh=mesh)
    _check(torch.equal(gather(tiled_decode(stream5, mesh=mesh, emit_u8=True)), img5),
           "5/3 mesh roundtrip not lossless")
    host5 = fetch_stream(stream5)
    _check(torch.equal(host5.ll.to(dev), gather(stream5.ll)), "fetched LL drift")
    for bands_a, bands_b in zip(host5.details, stream5.details):
        for a, b in zip(bands_a, bands_b):
            _check(torch.equal(a.to(dev), gather(b)), "fetched detail drift")
    back5 = deserialize(serialize(host5, threads=2), threads=2, device=dev)
    half = decode_at_level(back5, 2, emit_u8=True)
    _check(tuple(half.shape[-2:]) == (h5 >> 2, w5 >> 2), f"progressive decode shape {tuple(half.shape)}")
    _check(torch.equal(decode_region(back5, 0, 32, 32, 96, emit_u8=True), img5[..., 0:32, 32:96]),
           "region decode drift")

    # a data-parallel SGD step of a small classifier
    model = nets.init_weights(nets.SimpleCNN(num_classes=16, features=4), torch.Generator().manual_seed(0)).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    batch = np.random.default_rng(1).normal(size=(data * 4, 32, 32, 3)).astype(np.float32)
    rows = slice(axis_index(mesh, DATA_AXIS) * 4, axis_index(mesh, DATA_AXIS) * 4 + 4)
    xb = torch.from_numpy(batch[rows]).to(dev).permute(0, 3, 1, 2)
    yb = (torch.arange(data * 4) % 16)[rows].to(dev)
    out["dp_loss"] = float(train_step(model, opt, xb, yb, mesh.get_group(DATA_AXIS)))
    _check(np.isfinite(out["dp_loss"]), "training step produced non-finite loss")

    # tensor, pipeline and expert parallelism against their oracles
    mm = mp.model_mesh(device_type)
    tp = mp.tp_mlp_init(torch.Generator().manual_seed(2), 16, 8 * n, 16)
    x = torch.ones(4, 16)
    pp = mp.pp_stages_init(torch.Generator().manual_seed(3), n, 16)
    mbs = torch.ones(2 * n, 4, 16)
    moe = mp.moe_init(torch.Generator().manual_seed(4), n, 16, 32)
    tok = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 16)).astype(np.float32))
    for name, got, want in (("tp", mp.tp_mlp_apply(tp, x, mm), mp.tp_mlp_reference(tp, x)),
                            ("pp", mp.pp_apply(pp, mbs, mm), mp.pp_reference(pp, mbs)),
                            ("ep", mp.moe_apply(moe, tok, mm), mp.moe_reference(moe, tok))):
        got = got.cpu()
        _check(bool(torch.isfinite(got).all()), f"{name} produced non-finite output")
        out[f"{name}_max_abs_err"] = float((got - want).abs().max())
        _check(torch.allclose(got, want, rtol=1e-5, atol=1e-5), f"{name} differs from its oracle")
    out["launches"] = {k: v for k, v in {**dwt_cuda.LAUNCHES, **dwt53_cuda.LAUNCHES}.items() if v}
    return out


def dryrun_multichip(n_devices: int, device_type=None) -> list[dict]:
    """One step of each parallel path (see the module docstring) on a world
    of ``n_devices`` ranks that this call starts and ends. ``device_type``
    follows the device rule: None is CUDA, and with no card it raises unless
    the caller passes ``'cpu'``. On CUDA the ranks are one per card over
    NCCL when the host has ``n_devices`` cards, else ``n_devices`` gloo
    ranks sharing its cards (rank ``r`` on card ``r % count``; the port's
    exchanges stage through pinned host memory); ``'cpu'`` runs gloo ranks
    on the CPU. Returns every rank's measurements in rank order, each with
    ``launches``, the kernel launches that rank made (none on the CPU);
    any failed check raises."""
    from wicca_tpu_torch.parallel.launch import run_world
    from wicca_tpu_torch.parallel.mesh import mesh_device_type

    device_type = mesh_device_type(device_type)
    nccl = device_type == "cuda" and torch.cuda.device_count() >= n_devices
    return run_world(_dryrun_rank, n_devices, n_devices, device_type, backend="nccl" if nccl else "gloo",
                     device_type=device_type, timeout_s=120.0)
