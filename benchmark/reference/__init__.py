"""Plain references that decide ``correct``. They import neither JAX, nor
``wicca_tpu``, nor anything of ``wicca_tpu_torch``."""
