from cermvs_torch.io.pfm import read_pfm, write_pfm
from cermvs_torch.io.ply import read_ply, write_ply


def read_pfm_fast(path):
    """A PFM read through the host data runtime's codec (``io/native.py``),
    as the training loaders read depths; the same arrays as
    :func:`read_pfm`. No fallback: a failed build raises."""
    from cermvs_torch.io import native

    return native.read_pfm(path)
