"""The port's plots (``wicca_tpu_torch.viz``) on the cases of
``tests/test_viz.py``, with the Agg backend and ``device='cpu'``; every
icon they draw equals the one ``wicca_tpu.viz`` draws (tolerance 0)."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tests.test_torch_dwt97 import one_torch_thread  # noqa: E402,F401 (fixture)
from wicca_tpu import viz as jviz  # noqa: E402
from wicca_tpu_torch.coder import HaarCoder  # noqa: E402
from wicca_tpu_torch.config.constants import SIM_BEST_CLASS, SIM_CLASSES, SIM_CLASSES_PERC  # noqa: E402
from wicca_tpu_torch.viz import (  # noqa: E402
    plot_compare_metrics,
    plot_metric_radar,
    show_icon_on_image,
    show_image_vs_icon,
    visualize_comparison,
)


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


@pytest.fixture()
def comparison_df():
    return pd.DataFrame(
        {
            "Classifier": ["A", "A", "B", "B"],
            "Depth": [2, 3, 2, 3],
            SIM_CLASSES: [4.5, 4.0, 4.8, 4.2],
            SIM_CLASSES_PERC: [90.0, 80.0, 96.0, 84.0],
            SIM_BEST_CLASS: [88.0, 75.0, 92.0, 80.0],
        }
    )


def _img(shape=(64, 96, 3)):
    return np.random.default_rng(0).integers(0, 256, shape, np.uint8)


def drawn(fig) -> list:
    """The image arrays a figure draws, axis by axis."""
    return [np.asarray(im.get_array()) for ax in fig.axes for im in ax.images]


def assert_same_drawing(got, want):
    g, w = drawn(got), drawn(want)
    assert len(g) == len(w) and [ax.get_title() for ax in got.axes] == [ax.get_title() for ax in want.axes]
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("shape,depths", [((64, 96, 3), (1, 2)), ((45, 67, 3), (1, 3, 4)), ((37, 50), (2,))])
def test_show_image_vs_icon(shape, depths):
    img = _img(shape)
    fig = show_image_vs_icon(img, depths, device="cpu")
    assert len(fig.axes) == len(depths) + 1
    assert_same_drawing(fig, jviz.show_image_vs_icon(img, depths))


@pytest.mark.parametrize("shape,depth,border", [((64, 96, 3), 2, 2), ((45, 67, 3), 3, 1), ((37, 50, 3), 1, 0)])
def test_show_icon_on_image(shape, depth, border):
    img = _img(shape)
    assert_same_drawing(show_icon_on_image(img, depth, border=border, device="cpu"),
                        jviz.show_icon_on_image(img, depth, border=border))


def test_a_coder_draws_the_icons():
    """A coder passed in makes the icons (with the device where one is
    given, as a reference-shaped coder without it)."""
    img = _img()
    fig = show_image_vs_icon(img, (1, 2), coder=HaarCoder(), device="cpu")
    assert_same_drawing(fig, jviz.show_image_vs_icon(img, (1, 2)))

    class RefCoder:  # the reference's signature: no device
        def get_small_copy(self, image, depth):
            return HaarCoder().get_small_copy(image, depth, device="cpu")

    assert_same_drawing(show_icon_on_image(img, 2, coder=RefCoder()), jviz.show_icon_on_image(img, 2))


def test_icons_follow_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        show_image_vs_icon(_img(), (1, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        show_icon_on_image(_img(), 2)


def test_visualize_comparison(comparison_df):
    fig = visualize_comparison(comparison_df, SIM_CLASSES_PERC)
    want = jviz.visualize_comparison(comparison_df, SIM_CLASSES_PERC)
    assert [t.get_text() for t in fig.axes[0].texts] == [t.get_text() for t in want.axes[0].texts]
    with pytest.raises(ValueError):
        visualize_comparison(comparison_df, "nope")


def test_plot_metric_radar():
    fig = plot_metric_radar(["A", "B", "C"], [80.0, 90.0, 85.0])
    want = jviz.plot_metric_radar(["A", "B", "C"], [80.0, 90.0, 85.0])
    assert type(fig) is type(want)
    if hasattr(fig, "axes"):  # the matplotlib fallback (no plotly)
        np.testing.assert_array_equal(fig.axes[0].lines[0].get_ydata(), want.axes[0].lines[0].get_ydata())


def test_plot_compare_metrics(comparison_df):
    fig = plot_compare_metrics(comparison_df, SIM_CLASSES_PERC, SIM_BEST_CLASS)
    assert fig is not None
    with pytest.raises(ValueError):
        plot_compare_metrics(comparison_df, "nope", SIM_BEST_CLASS)


def test_plot_compare_metrics_reference_positional_form():
    """The reference's (names, metric1, metric2) value-list call, through the
    compat namespace."""
    from wicca_tpu_torch.compat import visualization as compat_viz

    fig = compat_viz.plot_compare_metrics(["A", "B"], [80.0, 85.0], [70.0, 75.0])
    assert fig is not None
    fig = compat_viz.plot_compare_metrics(
        ("A", "B", "C"), (1.0, 2.0, 3.0), (4.0, 5.0, 6.0),
        xlabel="x", ylabel="y", title="t",
    )
    want = jviz.plot_compare_metrics(("A", "B", "C"), (1.0, 2.0, 3.0), (4.0, 5.0, 6.0), xlabel="x", ylabel="y",
                                     title="t")
    if hasattr(fig, "axes"):
        ax, wax = fig.axes[0], want.axes[0]
        assert (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()) == (wax.get_xlabel(), wax.get_ylabel(),
                                                                       wax.get_title())
        assert [t.get_text() for t in ax.texts] == [t.get_text() for t in wax.texts]


def test_show_image_vs_icon_validates():
    with pytest.raises(ValueError):
        show_image_vs_icon(np.zeros((0, 4, 3), np.uint8), 2, device="cpu")


def test_plot_compare_metrics_requires_metrics(comparison_df):
    with pytest.raises(TypeError, match="two metrics"):
        plot_compare_metrics(comparison_df)
    with pytest.raises(TypeError, match="two metrics"):
        plot_compare_metrics(["A", "B"], [1.0, 2.0])
