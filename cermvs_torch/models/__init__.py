from cermvs_torch.models.extractor import BasicEncoder, ResidualBlock
from cermvs_torch.models.raft import RAFT
from cermvs_torch.models.update import ConvGRU, UpdateBlock
