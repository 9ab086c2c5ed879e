"""The benchmark of the PyTorch and CUDA port (``laff_tpu_torch``); see README.md."""
