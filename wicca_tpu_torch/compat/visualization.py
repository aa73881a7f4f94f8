"""The reference module ``wicca.visualization`` on the port."""

from wicca_tpu_torch.viz.plots import (  # noqa: F401
    plot_compare_metrics,
    plot_metric_radar,
    show_icon_on_image,
    show_image_vs_icon,
    visualize_comparison,
)
