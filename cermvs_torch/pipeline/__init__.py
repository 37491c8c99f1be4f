from cermvs_torch.pipeline.fusion import fusion
from cermvs_torch.pipeline.inference import InferenceRunner, inference
from cermvs_torch.pipeline.multires import multires
