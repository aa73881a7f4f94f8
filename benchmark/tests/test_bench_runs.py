"""Every runner's run at a tiny size on the CPU through the harness (its
look for a card skipped): correct on a sound program, and not correct with
the timed path broken underneath it: an answer altered where it is
produced, half of the batch left out."""

import pytest
import torch

from benchmark.tests._cells import TINY, run_cell, tiny_cell

CELLS = sorted(TINY)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace, tmp_path):
    rc, res, err = run_cell(tiny_cell(workload, tmp_path, trace=trace))
    assert rc == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, err
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + [
        "setup_parts", "checks"]
    assert "setup_s" in res["metrics"] if not trace else "window_s" in res["device"]
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert "build" in res["setup_parts"]
    cell = tiny_cell(workload, tmp_path)
    if not trace:  # (the CPU's trace holds no device time for the rooflines)
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_every_depth_is_warmed(tmp_path):
    rc, res, err = run_cell(tiny_cell("mobilenetv2.depths2-6", tmp_path))
    assert rc == 0 and res["correct"] and {"warm_call", "warm_depths"} <= set(res["setup_parts"]), err


def test_an_unsound_trace_is_traced_again_and_its_device_metrics_left_out(tmp_path, monkeypatch):
    from benchmark.runners import codec_resident

    calls = []

    def unsound(self, trace):
        calls.append(len(trace.steps))
        return False, "planted disagreement"

    monkeypatch.setattr(codec_resident.Runner, "trace_check", unsound)
    rc, res, err = run_cell(tiny_cell("haar-d5.resident", tmp_path, trace=True))
    assert rc == 0 and res["correct"] and len(calls) == 3 and all(calls), err
    assert "host_ms.resident" in res["metrics"], res
    assert not {"kernel_roofline.resident", "device_idle.resident"} & set(res["metrics"]), res
    assert "left out" in err


def _alter_codes(monkeypatch):
    import wicca_tpu_torch
    from wicca_tpu_torch.codec import pipeline

    real = pipeline.encode

    def encode(*a, **kw):
        stream = real(*a, **kw)
        stream.details[0][0].view(-1)[7] += 1
        return stream

    monkeypatch.setattr(wicca_tpu_torch, "encode", encode)


def _alter_pixel(monkeypatch):
    import wicca_tpu_torch
    from wicca_tpu_torch.codec import pipeline

    real = pipeline.decode

    def decode(*a, **kw):
        out = real(*a, **kw)
        out.view(-1)[11] ^= 1
        return out

    monkeypatch.setattr(wicca_tpu_torch, "decode", decode)


def _half_frame(monkeypatch):
    import wicca_tpu_torch
    from wicca_tpu_torch.codec import pipeline

    real = pipeline.decode

    def decode(*a, **kw):
        out = real(*a, **kw).clone()
        out[..., out.shape[-2] // 2 :, :] = 0  # half of the rows never decoded
        return out

    monkeypatch.setattr(wicca_tpu_torch, "decode", decode)


def _alter_logit(monkeypatch):
    from wicca_tpu_torch.models import registry

    real = registry.TorchClassifier._forward

    def forward(self, batch):
        out = real(self, batch)
        out[:, 3] += 1.0
        return out

    monkeypatch.setattr(registry.TorchClassifier, "_forward", forward)


def _alter_icon(monkeypatch):
    from wicca_tpu_torch.ops import dwt_cuda

    real = dwt_cuda.icon

    def icon(x, depth):
        out = real(x, depth).clone()
        out[..., 0, 0] ^= 1  # the first icon pixel of every plane (the rest may be bucket padding)
        return out

    monkeypatch.setattr(dwt_cuda, "icon", icon)


def _half_batch(monkeypatch):
    from wicca_tpu_torch.harness import processor

    real = processor.list_images
    monkeypatch.setattr(processor, "list_images", lambda folder: real(folder)[: max(1, len(real(folder)) // 2)])


FAULTS = {
    "haar-d5.resident": {"code": _alter_codes, "pixel": _alter_pixel, "half": _half_frame},
    "haar-d5.wct": {"code": _alter_codes, "pixel": _alter_pixel, "half": _half_frame},
    "mobilenetv2.2k-depth5": {"logit": _alter_logit, "icon": _alter_icon, "half": _half_batch},
    "mobilenetv2.depths2-6": {"logit": _alter_logit, "icon": _alter_icon, "half": _half_batch},
}


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CELLS for f in FAULTS[w]])
def test_broken_program_is_not_correct(workload, fault, tmp_path, monkeypatch):
    FAULTS[workload][fault](monkeypatch)
    rc, res, err = run_cell(tiny_cell(workload, tmp_path))
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1, (res, err)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, tmp_path):
    from benchmark.control import read

    torch.set_num_threads(2)
    got = read(tiny_cell(workload, tmp_path))
    assert got["correct"] is False, got
