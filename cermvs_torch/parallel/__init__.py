"""Everything the port does over more than one process: process groups and
``(data, view)``, ``(row,)`` and ``(row, view)`` meshes (``mesh.py``),
view-sharded inference (``infer.py``), row- and grid-sharded inference
(``spatial.py``) and the multi-process dry run (``dryrun.py``).
Data-parallel training lives in ``training/``, sharded fusion in
``pipeline/fusion.py``."""

from cermvs_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                        make_row_mesh, process_allgather)
