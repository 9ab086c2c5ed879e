"""laff_tpu_torch: the LAFF retrieval framework in PyTorch for one NVIDIA
H100, beside the JAX package ``laff_tpu`` it is held against.

Subpackages mirror ``laff_tpu``: store, text, data, ops, models, eval,
engine, configs, cli. The Pallas TPU kernels of ``laff_tpu`` become CUDA
kernels here (``laff_tpu_torch/csrc``, bound in ``ops/kernels.py``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
