"""Rank functions for the port's mesh tests (``tests/test_torch_mesh.py``,
``test_torch_tiled.py``, ``test_torch_tiled_codec.py``,
``test_torch_model_parallel.py``, ``test_torch_parallel_batch.py``).

Not a test module. Each function runs on every rank of a gloo world on the
CPU (:func:`wicca_tpu_torch.parallel.launch.run_world`) and returns plain
numpy results, which the tests compare with the JAX package in the pytest
process. This module imports torch and the port only: the ranks never
import JAX.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist


def _img(shape, seed, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8).astype(dtype)


def _np(t) -> np.ndarray:
    from wicca_tpu_torch.parallel import gather

    return gather(t).cpu().numpy()


def _stream_np(st) -> dict:
    return {"ll": _np(st.ll), "details": [[_np(b) for b in bands] for bands in st.details], "layout": st.layout,
            "shapes": [tuple(st.ll.shape)] + [tuple(b.shape) for bands in st.details for b in bands]}


def _raises(fn, exc=ValueError) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


# --------------------------------------------------------------------------
# tests/test_torch_mesh.py
# --------------------------------------------------------------------------


def mesh_checks() -> dict:
    """A 2-rank world: validation, coordinates over the first ranks, the
    health check live and with a rank that comes late."""
    from wicca_tpu_torch.parallel import data_mesh, init_distributed, make_mesh, mesh_health_check

    rank = dist.get_rank()
    out = {"too_big": _raises(lambda: make_mesh(4, 4, 4, device_type="cpu")),
           "already": init_distributed(backend="gloo")}
    one = make_mesh(1, 1, 1, device_type="cpu")
    out["coordinate"] = one.get_coordinate()
    meshes = [make_mesh(2, 1, 1, device_type="cpu"), make_mesh(1, 1, 2, device_type="cpu"), data_mesh("cpu")]
    out["live"] = [mesh_health_check(m, 30.0) for m in meshes]
    # rank 1 joins 3 s late: rank 0's check gives up after 1 s, then both pass
    late = meshes[0]
    if rank == 1:
        time.sleep(3.0)
    t0 = time.monotonic()
    out["late"] = mesh_health_check(late, 1.0 if rank == 0 else 30.0)
    out["late_s"] = time.monotonic() - t0
    dist.barrier()
    out["after"] = mesh_health_check(late, 30.0)
    # a mesh whose dims' groups are made on a named backend
    over = make_mesh(1, 1, 2, device_type="cpu", backend="gloo")
    group = over.get_group("tx")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t, group=group)
    out["override"] = {"backend": dist.get_backend(group), "own_group": group is not dist.group.WORLD,
                       "sum": float(t), "health": mesh_health_check(over, 30.0)}
    return out


def late_start(rank: int, port: int, delay_s: float, init_timeout_s: float, out_path: str) -> None:
    """One rank of a 2-rank world whose rank 0 (the store) starts
    ``delay_s`` late: ``init_distributed`` retries until it comes; writes
    (ok, attempts, all-reduce of ones) to ``out_path``."""
    import json
    import logging

    from wicca_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    failed = []

    class Count(logging.Handler):
        def emit(self, record):
            if "joining the process group failed" in record.getMessage():
                failed.append(record)

    logging.getLogger().addHandler(Count())
    time.sleep(delay_s)
    ok = init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=rank, retries=8,
                          backoff_s=0.5, init_timeout_s=init_timeout_s, backend="gloo")
    total = None
    if ok:
        t = torch.ones(1)
        dist.all_reduce(t)
        total = float(t)
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"ok": ok, "attempts": len(failed) + 1, "sum": total}, f)


# --------------------------------------------------------------------------
# tests/test_torch_tiled.py
# --------------------------------------------------------------------------

TILED_MESHES = {"1x8": (1, 1, 8), "2x4": (1, 2, 4), "4x2": (1, 4, 2), "2x2": (2, 2, 2)}
ICON_CASES = [("1x8", 1, (3, 256, 384)), ("2x4", 3, (3, 256, 384)), ("4x2", 5, (3, 256, 384)),
              ("2x2", 3, (3, 256, 384)), ("2x4", 3, (3, 250, 370))]
HALO_KS = (-2, -1, 0, 1, 2)


def tiled_checks() -> dict:
    """An 8-rank world: the halo shift, tiled icons, the tiled transforms
    and statistics on the meshes of ``tests/test_tiled.py``."""
    from wicca_tpu_torch.core.lifting import _shift
    from wicca_tpu_torch.parallel import make_mesh, tiled_dwt2, tiled_icon, tiled_idwt2, tiled_stats
    from wicca_tpu_torch.parallel.halo import shift_halo

    meshes = {k: make_mesh(*v, device_type="cpu") for k, v in TILED_MESHES.items()}
    out: dict = {}
    m = meshes["1x8"]
    x = torch.from_numpy(np.arange(2 * 64, dtype=np.float32).reshape(2, 64) * 3.1)
    ix = m.get_local_rank("tx")
    for k in HALO_KS:
        local = shift_halo(x[:, ix * 8:(ix + 1) * 8], k, m, "tx")
        full = [torch.empty_like(local) for _ in range(8)]
        dist.all_gather(full, local.contiguous(), group=m.get_group("tx"))
        out[f"halo{k}"] = (torch.cat(full, dim=-1).numpy(), _shift(x, k).numpy())
    out["halo_too_wide"] = _raises(lambda: shift_halo(torch.zeros(2, 2), 5, m, "tx"))

    for key, depth, shape in ICON_CASES:
        out[f"icon_{key}_{depth}_{shape[1]}"] = _np(tiled_icon(_img(shape, 9 if shape[1] == 250 else depth), depth,
                                                               mesh=meshes[key]))
    for wavelet in ("haar", "haar_int"):
        img = torch.from_numpy(_img((3, 128, 256), 4))
        pyr = tiled_dwt2(img, 3, wavelet, mesh=meshes["2x4"])
        out[f"pyr_{wavelet}"] = _pyr_np(pyr)
        out[f"rec_{wavelet}"] = _np(tiled_idwt2(pyr, mesh=meshes["2x4"]))
    img = torch.from_numpy(_img((1, 128, 256), 12))
    pyr = tiled_dwt2(img, 3, "legall5.3", mesh=meshes["2x4"])
    out["pyr_legall5.3"], out["rec_legall5.3"] = _pyr_np(pyr), _np(tiled_idwt2(pyr, mesh=meshes["2x4"]))
    for wavelet, key in (("db2", "2x4"), ("bior4.4", "1x8"), ("bior4.4", "4x2")):
        img = torch.from_numpy(_img((1, 128, 128), 6, np.float32))
        pyr = tiled_dwt2(img, 2, wavelet, mesh=meshes[key])
        out[f"pyr_{wavelet}_{key}"] = _pyr_np(pyr)
        out[f"rec_{wavelet}_{key}"] = _np(tiled_idwt2(pyr, mesh=meshes[key]))
    img = torch.from_numpy(_img((1, 100, 172), 8, np.float32))
    out["rec_odd_bior4.4"] = _np(tiled_idwt2(tiled_dwt2(img, 2, "bior4.4", mesh=meshes["2x4"]), mesh=meshes["2x4"]))
    out["stats"] = tiled_stats(torch.from_numpy(_img((1, 64, 128), 11)), mesh=meshes["2x4"])
    out["stats_dtensor"] = tiled_stats(tiled_icon(_img((1, 64, 128), 11), 1, mesh=meshes["2x4"]), mesh=meshes["2x4"])
    return out


def _pyr_np(pyr) -> dict:
    return {"ll": _np(pyr.ll), "details": [[_np(b) for b in bands] for bands in pyr.details]}


# --------------------------------------------------------------------------
# tests/test_torch_tiled_codec.py
# --------------------------------------------------------------------------

SMALL_MESHES = {"1x4": (1, 1, 4), "2x2": (1, 2, 2), "4x1": (1, 4, 1)}
# (wavelet, shape, seed, levels) held bit for bit on every small mesh
IDENTITY_CASES = [("haar", (1, 100, 172), 20, 3), ("haar", (1, 1088, 256), 5, 2), ("haar_int", (3, 100, 172), 21, 3),
                  ("legall5.3", (1, 2048, 4096), 22, 2)]


def codec_checks() -> dict:
    """An 8-rank world: the cases of ``tests/test_tiled_codec.py`` on its
    (1, 2, 4) mesh, and the pair-local and aligned streams on the 4-rank
    meshes 1x4, 2x2 and 4x1, each against the single-device port and on
    ``.wct`` bytes."""
    from wicca_tpu_torch import QuantSpec, decode, decode_at_level, decode_region, encode, icon_from_stream
    from wicca_tpu_torch.codec import apply_roi, deserialize, fetch_stream, serialize
    from wicca_tpu_torch.codec.pipeline import _encode_global
    from wicca_tpu_torch.parallel import make_mesh, tiled_decode, tiled_encode
    from wicca_tpu_torch.parallel.codec import mesh53_aligned

    mesh = make_mesh(1, 2, 4, device_type="cpu")
    small = {k: make_mesh(*v, device_type="cpu") for k, v in SMALL_MESHES.items()}
    spec = QuantSpec(base_step=1.0)
    out: dict = {}

    def single(x, **kw):
        return encode(torch.from_numpy(x), device="cpu", **kw)

    x = _img((3, 64, 128), 0)
    st = tiled_encode(x, levels=2, wavelet="haar_int", mesh=mesh)
    out["haar_int"] = _stream_np(st)
    out["haar_int_single"] = _stream_np(single(x, levels=2, wavelet="haar_int"))
    out["haar_int_decode"] = decode(st, emit_u8=True).numpy()
    out["haar_int_tiled_decode"] = _np(tiled_decode(st, mesh=mesh, emit_u8=True))
    out["haar_int_wct"] = (serialize(st), serialize(single(x, levels=2, wavelet="haar_int")))

    x = _img((1, 64, 128), 1)
    st, ss = tiled_encode(x, levels=2, spec=spec, wavelet="haar", mesh=mesh), single(x, levels=2, spec=spec)
    out["haar"] = _stream_np(st)
    out["haar_decode"] = (decode(st).numpy(), decode(ss).numpy())
    out["haar_single_on_mesh"] = _np(tiled_decode(ss, mesh=mesh))
    out["haar_wct"] = (serialize(st), serialize(ss))

    x = _img((1, 64, 128), 2)
    st = tiled_encode(x, levels=2, spec=spec, wavelet="bior4.4", mesh=mesh)
    gll, gdets = _encode_global(torch.from_numpy(x).float(), 2, spec, "bior4.4", torch.int16)
    out["bior44"] = _stream_np(st)
    out["bior44_global_single"] = {"ll": gll.numpy(), "details": [[b.numpy() for b in bands] for bands in gdets]}
    out["bior44_rec"] = (_np(tiled_decode(st, mesh=mesh)), decode(st).numpy())
    out["bior44_wct"] = (serialize(st), serialize(dataclasses_replace(st, gll, gdets)))

    x = _img((3, 64, 128), 3)
    st = tiled_encode(x, levels=2, wavelet="legall5.3", color="rct", mesh=mesh)
    blob = serialize(st, quality_layers=3)
    out["layers"] = {"layout": st.layout, "stream": _stream_np(st), "blob": blob,
                     "full": decode(deserialize(blob, device="cpu"), emit_u8=True).numpy(),
                     "preview": decode(deserialize(blob, max_layers=1, device="cpu"), emit_u8=True).numpy()}

    x = _img((1, 1088, 256), 5)
    st, ss = tiled_encode(x, levels=2, spec=spec, wavelet="haar", mesh=mesh), single(x, levels=2, spec=spec)
    out["tile_pad"] = _stream_np(st)
    out["tile_pad_single"] = _stream_np(ss)
    out["tile_pad_decode"] = (_np(tiled_decode(st, mesh=mesh, emit_u8=True)), decode(ss, emit_u8=True).numpy())

    out["aligned_flags"] = (mesh53_aligned(1024, 4096, 2, 4, 2), mesh53_aligned(1024, 4096, 2, 4, 5))
    x = _img((1, 1024, 4096), 6)
    st = tiled_encode(x, levels=2, wavelet="legall5.3", mesh=mesh)
    out["aligned"] = _stream_np(st)
    out["aligned_single"] = _stream_np(single(x, levels=2, wavelet="legall5.3"))
    out["aligned_decode"] = _np(tiled_decode(st, mesh=mesh, emit_u8=True))

    x = _img((1, 96, 160), 8)
    out["fallback"] = (_np(tiled_decode(single(x, levels=2, wavelet="legall5.3"), mesh=mesh, emit_u8=True)), x)

    x = _img((3, 32, 32), 4)
    out["bad_color"] = (_raises(lambda: tiled_encode(x, levels=1, wavelet="haar", color="rct", mesh=mesh)),
                        _raises(lambda: tiled_encode(x, levels=1, wavelet="haar_int", color="ict", mesh=mesh)))

    # ROI: the mesh decode undoes the maxshift as the single-device decode does
    x = _img((3, 96, 160), 9)
    mask = np.zeros((96, 160), bool)
    mask[8:40, 16:100] = True
    roi = apply_roi(single(x, levels=3, spec=QuantSpec(0.5)), mask, bg_shift=2)
    out["roi"] = (_np(tiled_decode(roi, mesh=mesh, emit_u8=True)), decode(roi, emit_u8=True).numpy())

    # the decoders, the container and the fetch take a mesh stream
    x = _img((3, 96, 160), 10)
    st, ss = tiled_encode(x, levels=3, spec=spec, mesh=mesh), single(x, levels=3, spec=spec)
    out["readers"] = [(decode_at_level(st, 1).numpy(), decode_at_level(ss, 1).numpy()),
                      (decode_region(st, 10, 70, 20, 150, emit_u8=True).numpy(),
                       decode_region(ss, 10, 70, 20, 150, emit_u8=True).numpy()),
                      (icon_from_stream(st).numpy(), icon_from_stream(ss).numpy()),
                      (fetch_stream(st).ll.numpy(), ss.ll.numpy())]

    for key, m in small.items():
        if m.get_coordinate() is None:
            continue  # ranks 4-7 are not in the 4-rank meshes
        for wavelet, shape, seed, levels in IDENTITY_CASES:
            x = _img(shape, seed)
            kw = dict(levels=levels, spec=spec, wavelet=wavelet)
            st, ss = tiled_encode(x, mesh=m, **kw), single(x, **kw)
            out[f"{key}_{wavelet}_{shape[1]}"] = {
                "mesh": _stream_np(st), "single": _stream_np(ss), "wct": (serialize(st), serialize(ss)),
                "decode": (_np(tiled_decode(st, mesh=m, emit_u8=True)), decode(ss, emit_u8=True).numpy())}
    return out


def dataclasses_replace(st, ll, details):
    import dataclasses

    return dataclasses.replace(st, ll=ll, details=tuple(tuple(bands) for bands in details))


# --------------------------------------------------------------------------
# tests/test_torch_model_parallel.py
# --------------------------------------------------------------------------


def model_parallel_checks(params: dict, inputs: dict) -> dict:
    """A 4-rank world: tp, pp and ep with the JAX package's parameters
    carried across, and a pp stage-count mismatch."""
    from wicca_tpu_torch.parallel import model_parallel as mp

    mm = mp.model_mesh("cpu")
    carried = {k: mp.from_jax_params(v) for k, v in params.items()}
    out = {"tp": mp.tp_mlp_apply(carried["tp"], torch.from_numpy(inputs["tp"]), mm).numpy(),
           "pp": mp.pp_apply(carried["pp"], torch.from_numpy(inputs["pp"]), mm).numpy(),
           "ep": mp.moe_apply(carried["ep"], torch.from_numpy(inputs["ep"]), mm).numpy()}
    shards = mp.shard_params(carried["tp"], mp.tp_mlp_placements(), mm)
    out["tp_dtensor"] = mp.tp_mlp_apply(shards, torch.from_numpy(inputs["tp"]), mm).numpy()
    try:
        mp.pp_apply(carried["pp_double"], torch.from_numpy(inputs["pp"]), mm)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


# --------------------------------------------------------------------------
# tests/test_torch_parallel_batch.py
# --------------------------------------------------------------------------


def batch_checks(images: np.ndarray, root: str, broken_root: str, config: dict, init_state: dict,
                 ckpt: str) -> dict:
    """A 2-rank world: the data-parallel codec calls, the scaling rows, and
    the trainer over a ``data=2`` mesh from carried weights, on ``root`` and
    on ``broken_root`` (the same folder and an unreadable image)."""
    from wicca_tpu_torch import QuantSpec
    from wicca_tpu_torch.harness import train as T
    from wicca_tpu_torch.parallel import batch as pbatch
    from wicca_tpu_torch.parallel import data_mesh, gather, make_mesh
    from wicca_tpu_torch.parallel.scaling import measure_scaling

    mesh = make_mesh(2, 1, 1, device_type="cpu")
    spec = QuantSpec(1.0)
    x = torch.from_numpy(images)
    out = {"psnr": pbatch.dp_encode_decode_psnr(x, 2, spec, mesh=mesh).numpy(),
           "icons": gather(pbatch.dp_icons(x, 2, mesh=mesh)).numpy(),
           "sweep": pbatch.depth_sweep_psnr(x, (1, 2), spec, mesh=mesh)}
    out["scaling"] = measure_scaling((64, 96), levels=2, wavelet="bior4.4", iters=1, device_type="cpu")
    make = T.init_model

    def init_model(cfg, num_classes):
        model = make(cfg, num_classes)
        model.load_state_dict(init_state, strict=True)
        return model

    T.init_model = init_model
    state, info = T.finetune_on_icons(root, T.TrainConfig(**config, checkpoint_dir=ckpt), mesh=data_mesh("cpu"))
    out["train"] = ({k: v.numpy() for k, v in state.items()}, info)
    state, info = T.finetune_on_icons(broken_root, T.TrainConfig(**config), mesh=data_mesh("cpu"))
    out["train_broken"] = ({k: v.numpy() for k, v in state.items()}, info)
    return out
