"""The reference's plots (counterpart of ``wicca_tpu/viz``)."""

from wicca_tpu_torch.viz.plots import (
    plot_compare_metrics,
    plot_metric_radar,
    show_icon_on_image,
    show_image_vs_icon,
    visualize_comparison,
)

__all__ = ["plot_compare_metrics", "plot_metric_radar", "show_icon_on_image", "show_image_vs_icon",
           "visualize_comparison"]
