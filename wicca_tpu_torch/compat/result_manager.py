"""The reference module ``wicca.result_manager`` on the port."""

from wicca_tpu_torch.analysis.results import (  # noqa: F401
    ResultPaths,
    compare_summaries,
    extract_from_comparison,
    extract_item_from_preds,
    get_short_comparison,
    load_summary_results,
)
