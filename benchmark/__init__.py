"""The benchmark of ``wicca_tpu_torch`` on one CUDA card (see README.md)."""
