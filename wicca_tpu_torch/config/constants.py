"""Shared constant strings and paths (counterpart of
``wicca_tpu/config/constants.py``).

The classifier-dict keys and the CSV column names are the results contract
shared with the reference and the JAX package; they must not change.
"""

from pathlib import Path

PROJECT_ROOT = Path(__file__).resolve().parent.parent.parent
RESULTS_FOLDER = PROJECT_ROOT / "results"

# Classifier-dict keys
MODEL = "model"
PRE_INP = "preprocess_input"
DEC_PRED = "decode_predictions"
SHAPE = "shape"
ICON = "icon"
SOURCE = "source"

# CSV column names: the cross-framework results contract
FILE = "file"
SIM_CLASSES = "similar classes (count)"
SIM_CLASSES_PERC = "similar classes (%)"
SIM_BEST_CLASS = "similar best class"

MAX_INFO_SAMPLE_SIZE = 50
