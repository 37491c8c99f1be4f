"""Configurables of pipeline stages the port does not have yet.

They are registered under the JAX package's names and accept the same
parameters, so the shipped ``configs/*.gin`` files parse and bind against
the port; calling one raises ``NotImplementedError``.
"""

from __future__ import annotations

from cermvs_torch.config import configurable


@configurable("multires")
def multires(output_folder, suffix1="", suffix2="", th=0.02, down_sample=1,
             visualize=False):
    raise NotImplementedError("multires is not ported yet (see ROADMAP.md)")


@configurable("fusion")
def fusion(data_loader, output_folder, suffix="", glb: float = 0.25,
           rescale: float = 1, tot_iter: int = 10, mesh=None,
           view_batch: int = 0, stream: bool = False,
           stream_above_bytes: int = 4 << 30, multihost: bool = True):
    raise NotImplementedError("fusion is not ported yet (see ROADMAP.md)")
