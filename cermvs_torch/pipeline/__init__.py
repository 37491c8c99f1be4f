from cermvs_torch.pipeline.inference import InferenceRunner, inference
from cermvs_torch.pipeline.stubs import fusion, multires
