"""The benchmark of the PyTorch and CUDA port (``cermvs_torch``): cells of a
model configuration under a traffic mix, run by ``portbench/run.py``."""
