"""The benchmark of cpkrylov_tpu_torch (see ``run.py``)."""
