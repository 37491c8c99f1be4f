"""cermvs_torch: the PyTorch/CUDA port of CER-MVS depth inference, the
multires merge, fusion and training.

Mirrors the layout of the JAX package (``models/``, ``ops/``, ``pipeline/``,
``io/``, ``data/``, ``training/``, ``utils/``) and shares no code with it.
Its kernels are hand-written CUDA (``csrc/epiband.cu``, ``hatwarp.cu``,
``lookup.cu``) and run on CUDA tensors.
"""

__version__ = "0.1.0"
