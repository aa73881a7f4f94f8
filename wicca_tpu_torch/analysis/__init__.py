from wicca_tpu_torch.analysis.results import (
    compare_summaries,
    extract_from_comparison,
    get_short_comparison,
    load_summary_results,
    save_results,
    summarize,
)
