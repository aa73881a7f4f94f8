"""Per-image agreement metrics, CSV persistence and cross-run comparison
(counterpart of ``wicca_tpu/analysis/results.py``).

CSV layout: ``results/depth-{d}/{name}-depth-{d}.csv`` and
``{name}-summary-depth-{d}.csv``; the summary is ``describe()`` sliced to
mean/min/max. The column names of :mod:`wicca_tpu_torch.config.constants`
are the contract; the files equal the JAX package's byte for byte
(``tests/test_torch_harness.py``). The lenient-input quirks of
:func:`load_summary_results` and :func:`compare_summaries` are kept.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import pandas as pd

from wicca_tpu_torch.config.aliases import Depth
from wicca_tpu_torch.config.constants import (
    FILE,
    ICON,
    SIM_BEST_CLASS,
    SIM_CLASSES,
    SIM_CLASSES_PERC,
    SOURCE,
)
from wicca_tpu_torch.data.normalization import normalize_depth
from wicca_tpu_torch.data.validation import validate_input_folder

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ResultPaths:
    regular: Path
    summary: Path


def extract_item_from_preds(preds: list, idx: int) -> list | None:
    """Column ``idx`` of a list of (wnid, name, score) tuples; None for
    ``idx > 2``."""
    if idx > 2:
        return None
    return [pred[idx] for pred in preds]


def get_short_comparison(results: dict, top: int) -> pd.DataFrame:
    """Per-image similarity metrics between source and icon predictions.

    ``results``: {file: {SOURCE: [decoded_preds], ICON: [decoded_preds]}}
    where decoded_preds is the decode_predictions output for one image
    (a list wrapping one list of top-k tuples).

    Metrics:
      similar classes (count) = |top-k(src) ∩ top-k(icon)| by class *name*
      similar classes (%)     = count / top * 100
      similar best class      = 100.0 if argmax class matches else 0.0
    """
    file_names, similar, similar_pct, best_eq = [], [], [], []
    for file, preds in results.items():
        file_names.append(file)
        src_classes = extract_item_from_preds(preds[SOURCE][0], 1)
        icn_classes = extract_item_from_preds(preds[ICON][0], 1)
        count = len(set(src_classes) & set(icn_classes))
        similar.append(count)
        similar_pct.append(float(count / top) * 100)
        best_eq.append(float(src_classes[0] == icn_classes[0]) * 100)
    return pd.DataFrame(
        {FILE: file_names, SIM_CLASSES: similar, SIM_CLASSES_PERC: similar_pct, SIM_BEST_CLASS: best_eq}
    )


def summarize(res_df: pd.DataFrame) -> pd.DataFrame:
    """describe() sliced to mean/min/max with 'stat' index name."""
    sum_df = res_df.describe().loc[["mean", "min", "max"]]
    sum_df.index.name = "stat"
    return sum_df


def result_paths(results_folder: Path, depth, classifier_name: str) -> ResultPaths:
    """The CSV paths of one (classifier, depth)."""
    base = Path(results_folder) / f"depth-{depth}"
    return ResultPaths(
        regular=base / f"{classifier_name}-depth-{depth}.csv",
        summary=base / f"{classifier_name}-summary-depth-{depth}.csv",
    )


def save_results(results_folder: Path, depth, name: str, result: pd.DataFrame, summary: pd.DataFrame) -> ResultPaths:
    """Write the per-image and summary CSVs."""
    paths = result_paths(results_folder, depth, name)
    paths.regular.parent.mkdir(parents=True, exist_ok=True)
    result.to_csv(paths.regular)
    summary.to_csv(paths.summary)
    return paths


def load_summary_results(
    results_folder: Path, classifier_name: str, depth: int, describe: bool = False
) -> pd.DataFrame | None:
    """Load one summary CSV; ``None`` when absent.

    Lenient-input quirks, kept: a non-int ``depth`` falls back to 3 with a
    warning; a non-str ``classifier_name`` is logged but the lookup still
    proceeds; a non-bool ``describe`` is treated as False.
    """
    validate_input_folder(results_folder, ftype="result")
    if type(describe) is not bool:
        log.warning("describe=%r is not a bool; ignoring it", describe)
        describe = False
    if isinstance(depth, bool) or not isinstance(depth, int):
        log.warning("depth=%r is not an int; falling back to depth 3", depth)
        depth = 3
    if not isinstance(classifier_name, str):
        log.error(
            "classifier name %r should be a string (a classifiers-dict key); trying anyway",
            classifier_name,
        )
    csv_path = result_paths(results_folder, depth, classifier_name).summary
    if not csv_path.is_file():
        log.warning("summary CSV missing: %s", csv_path)
        return None
    summary_df = pd.read_csv(csv_path)
    if describe:
        print(f"\n{classifier_name} @ depth {depth}: {summary_df.shape[0]}x{summary_df.shape[1]}")
        print("columns:", list(summary_df.columns))
    return summary_df


def compare_summaries(
    results_folder: Path,
    classifier_names: list[str],
    depths: Depth,
    target_stat: str = "mean",
) -> pd.DataFrame:
    """One comparison row per (classifier, depth) pair with a summary CSV.

    ``classifier_names`` may also be a classifiers dict (iteration yields
    its keys). A ``target_stat`` that is not a string falls back to
    ``'mean'``.
    """
    if not isinstance(target_stat, str):
        log.warning("stat selector %r is not a string; using 'mean'", target_stat)
        target_stat = "mean"
    rows = []
    for classifier in classifier_names:
        for depth in normalize_depth(depths):
            summary_df = load_summary_results(results_folder, classifier, depth)
            if summary_df is None:
                continue
            stats = summary_df.set_index(summary_df.columns[0])
            if target_stat not in stats.index:
                log.warning(
                    "no %r row in summary for %s @ depth %d; skipping", target_stat, classifier, depth
                )
                continue
            picked = stats.loc[target_stat]
            row = {"Classifier": classifier, "Depth": depth}
            row.update({col: picked[col] for col in (SIM_CLASSES, SIM_CLASSES_PERC, SIM_BEST_CLASS)})
            rows.append(row)
    return pd.DataFrame(rows)


def extract_from_comparison(comparison_data: pd.DataFrame, metric: str) -> tuple[list[str], list]:
    """(classifier names, metric values) from a comparison table."""
    if metric not in comparison_data.columns:
        raise ValueError(f"no column {metric!r} in the comparison table")
    return comparison_data["Classifier"].tolist(), comparison_data[metric].tolist()
