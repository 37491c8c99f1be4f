"""cermvs_torch: the PyTorch/CUDA port of CER-MVS depth inference.

Mirrors the layout of the JAX package (``models/``, ``ops/``, ``pipeline/``,
``io/``, ``data/``, ``utils/``) and shares no code with it. The rectified
cost volume's band resample runs as a hand-written CUDA kernel
(``csrc/epiband.cu``) on CUDA tensors.
"""

__version__ = "0.1.0"
