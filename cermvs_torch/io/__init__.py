from cermvs_torch.io.pfm import read_pfm, write_pfm
