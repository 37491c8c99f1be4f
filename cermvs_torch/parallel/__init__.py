"""Everything the port does over more than one process: process groups and
``(data, view)`` meshes (``mesh.py``), view-sharded inference
(``infer.py``) and the multi-process dry run (``dryrun.py``).
Data-parallel training lives in ``training/``, sharded fusion in
``pipeline/fusion.py``."""

from cermvs_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                        process_allgather)
