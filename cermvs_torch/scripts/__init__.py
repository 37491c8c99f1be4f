"""Cluster fan-out of the port's CLIs: ``submitter`` (SLURM or local) and
the per-scan depth-map and fusion jobs (``python -m
cermvs_torch.scripts.submit_depthmap``, ``... .submit_fusion``)."""
