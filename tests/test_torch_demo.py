"""``examples/demo_torch.py``, the port's twin of ``examples/demo.py``, run
on the CPU (``--device cpu``): it exits 0 with its plots where matplotlib
and seaborn are found, exits 0 without them and says so where they are
not, and follows the device rule (no card and no ``--device cpu``:
raises before it writes anything)."""

import importlib.util
import pathlib

import pytest
import torch

DEMO = pathlib.Path(__file__).resolve().parent.parent / "examples" / "demo_torch.py"
PNGS = {"image_vs_icon.png", "icon_on_image.png", "heatmap.png"}


def _demo():
    spec = importlib.util.spec_from_file_location("demo_torch", DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plots", [True, False])
def test_demo_runs_on_the_cpu(plots, tmp_path, monkeypatch, capsys):
    pytest.importorskip("cv2")
    demo = _demo()
    if not plots:
        find_spec = importlib.util.find_spec
        monkeypatch.setattr(demo.importlib.util, "find_spec",
                            lambda name, *a: None if name == "seaborn" else find_spec(name, *a))
    elif not all(importlib.util.find_spec(m) for m in ("matplotlib", "seaborn")):
        pytest.skip("matplotlib and seaborn are not both installed")
    assert demo.main([str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "lossless 5/3+RCT" in out and "bit-exact" in out and "SimpleCNN" in out
    pngs = {p.name for p in tmp_path.glob("*.png")}
    if plots:
        assert PNGS <= pngs and f"plots written to {tmp_path}/" in out
    else:
        assert pngs == set() and "plots skipped: seaborn not installed" in out
    assert (tmp_path / "img_00.wct").is_file() and (tmp_path / "img_00_lossless.wct").is_file()


def test_demo_needs_a_card_or_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _demo().main([str(tmp_path)])
    assert list(tmp_path.iterdir()) == []
