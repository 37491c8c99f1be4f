from cermvs_torch.io.pfm import read_pfm, write_pfm
from cermvs_torch.io.ply import read_ply, write_ply
