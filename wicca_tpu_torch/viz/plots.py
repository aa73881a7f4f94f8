"""Visualization (counterpart of ``wicca_tpu/viz/plots.py``): the
reference's five plotting entry points on matplotlib and seaborn.

Radar and scatter plots use plotly when it is installed and fall back to
matplotlib otherwise. matplotlib, seaborn and plotly are imported inside the
functions, so importing this module needs none of them. Images are HWC
uint8, as the reference takes them. The functions that draw icons make them
with the harness's icon path (:func:`wicca_tpu_torch.harness.processor._compute_icon`,
the icon kernel K1) on ``device``: the card unless the caller passes
``device='cpu'``; with no card and no explicit CPU device they raise.
"""

from __future__ import annotations

import logging

import numpy as np

from wicca_tpu_torch.config.constants import SIM_CLASSES_PERC
from wicca_tpu_torch.data.normalization import normalize_depth
from wicca_tpu_torch.data.validation import validate_image


def _icon_of(image_hwc: np.ndarray, depth: int, coder=None, device=None) -> np.ndarray:
    if coder is not None and hasattr(coder, "get_small_copy"):
        if device is None:  # a reference-shaped coder takes no device
            return coder.get_small_copy(image_hwc, depth)
        return coder.get_small_copy(image_hwc, depth, device=device)
    from wicca_tpu_torch.harness.processor import _compute_icon

    return _compute_icon(image_hwc, depth, device)


def show_image_vs_icon(image: np.ndarray, depths, coder=None, figsize=(14, 6), device=None):
    """The original next to its icon at each depth."""
    import matplotlib.pyplot as plt

    validate_image(image)
    depths = normalize_depth(depths)
    fig, axes = plt.subplots(1, len(depths) + 1, figsize=figsize)
    axes = np.atleast_1d(axes)
    axes[0].imshow(image)
    axes[0].set_title(f"Original {image.shape[1]}x{image.shape[0]}")
    axes[0].axis("off")
    for ax, d in zip(axes[1:], depths):
        icon = _icon_of(image, d, coder, device)
        ax.imshow(icon)
        ax.set_title(f"depth {d}: {icon.shape[1]}x{icon.shape[0]}")
        ax.axis("off")
    fig.tight_layout()
    return fig


def show_icon_on_image(image: np.ndarray, depth: int, coder=None, border: int = 2, figsize=(8, 8), device=None):
    """The icon, in a white border, pasted into the original's top-left
    corner."""
    import matplotlib.pyplot as plt

    validate_image(image)
    (depth,) = normalize_depth(depth)
    icon = _icon_of(image, depth, coder, device)
    canvas = image.copy()
    ih, iw = icon.shape[:2]
    bh, bw = ih + 2 * border, iw + 2 * border
    canvas[:bh, :bw] = 255
    canvas[border : border + ih, border : border + iw] = icon if icon.ndim == 3 else icon[..., None]
    fig, ax = plt.subplots(figsize=figsize)
    ax.imshow(canvas)
    ax.set_title(f"Icon (depth {depth}) on image")
    ax.axis("off")
    return fig


def visualize_comparison(comparison_df, metric: str = SIM_CLASSES_PERC, figsize=(8, 5)):
    """Classifier x depth heatmap of one metric of the comparison table."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    if metric not in comparison_df.columns:
        raise ValueError(f"no column {metric!r} in the comparison table")
    pivot = comparison_df.pivot(index="Classifier", columns="Depth", values=metric)
    fig, ax = plt.subplots(figsize=figsize)
    sns.heatmap(pivot, annot=True, fmt=".2f", cmap="viridis", ax=ax)
    ax.set_title(metric)
    return fig


def plot_metric_radar(names: list[str], metric: list[float], title: str = "Metric radar"):
    """Radar chart of one metric across classifiers (plotly's Scatterpolar,
    or a matplotlib polar plot without plotly)."""
    try:
        import plotly.graph_objects as go

        fig = go.Figure(go.Scatterpolar(r=list(metric) + [metric[0]], theta=list(names) + [names[0]], fill="toself"))
        fig.update_layout(title=title)
        return fig
    except ImportError:
        logging.info("plotly not installed; using matplotlib polar fallback")
        import matplotlib.pyplot as plt

        angles = np.linspace(0, 2 * np.pi, len(names), endpoint=False)
        values = np.asarray(list(metric), dtype=float)
        angles_c = np.concatenate([angles, angles[:1]])
        values_c = np.concatenate([values, values[:1]])
        fig, ax = plt.subplots(figsize=(6, 6), subplot_kw={"projection": "polar"})
        ax.plot(angles_c, values_c, "o-")
        ax.fill(angles_c, values_c, alpha=0.25)
        ax.set_xticks(angles)
        ax.set_xticklabels(names)
        ax.set_title(title)
        return fig


def plot_compare_metrics(comparison_df, x_metric=None, y_metric=None, title: str = "Metric comparison",
                         xlabel: str | None = None, ylabel: str | None = None):
    """Scatter of two metrics with classifier/depth labels (plotly, or
    matplotlib without it).

    Takes both calling conventions:

    * the DataFrame form, ``(comparison_df, "x_col", "y_col")``, with column
      names of the cross-run comparison table;
    * the reference's positional form, ``(names, metric1, metric2)``, value
      sequences as ``extract_from_comparison`` gives them, with the
      reference's axis labels and title as defaults.
    """
    if x_metric is None or y_metric is None:
        raise TypeError(
            "plot_compare_metrics needs two metrics: either column names "
            "(DataFrame form) or value sequences (reference form)"
        )
    if not hasattr(comparison_df, "columns"):  # the reference's value-list form
        names = list(comparison_df)
        xs = np.asarray(list(x_metric), dtype=float)
        ys = np.asarray(list(y_metric), dtype=float)
        x_name = xlabel or "Similar classes, %"
        y_name = ylabel or "Best class similarity, %"
        if title == "Metric comparison":
            title = "Classifier Performance Comparison"
        return _scatter_labeled(xs, ys, names, x_name, y_name, title)
    for m in (x_metric, y_metric):
        if m not in comparison_df.columns:
            raise ValueError(f"no column {m!r} in the comparison table")
    labels = [f"{c} d{d}" for c, d in zip(comparison_df["Classifier"], comparison_df["Depth"])]
    return _scatter_labeled(
        np.asarray(comparison_df[x_metric]), np.asarray(comparison_df[y_metric]),
        labels, xlabel or x_metric, ylabel or y_metric, title,
    )


def _scatter_labeled(xs, ys, labels, x_name, y_name, title):
    try:
        import plotly.express as px

        fig = px.scatter(x=xs, y=ys, text=labels, labels={"x": x_name, "y": y_name}, title=title)
        fig.update_traces(textposition="top center", marker_size=12)
        return fig
    except ImportError:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        ax.scatter(xs, ys)
        for x, y, lbl in zip(xs, ys, labels):
            ax.annotate(lbl, (x, y), fontsize=8)
        ax.set_xlabel(x_name)
        ax.set_ylabel(y_name)
        ax.set_title(title)
        return fig
