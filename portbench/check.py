"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``portbench/reference``), which works out the
routes, plans and state again itself from the benchmark's inputs.

Inference: each sampled view's depth map, as the program wrote it, is
turned back into disparities and compared with the reference's forward of
the same frames, poses and weights: the widest and the root-mean-square
gap over the view's pixels, in units of the finest hypothesis spacing, at
the worst view.

Training: the reference follows the program's first three steps from the
same weights on the same batches, and three numbers are compared (with
the median leaf's gaps of the last two beside them, ``grad_median`` and
``change_median``, which a cell compares where it names them):
  * ``loss_gap``: the widest relative gap of a step's loss;
  * ``grad_gap``: the first gradient as the optimizer got it, leaf by
    leaf: the gap between the norms, over the reference's norm of the leaf
    or of the median leaf, whichever is larger, at the worst leaf;
  * ``change_gap``: the same of each leaf's change over the three steps,
    leaving out leaves whose reference gradient is under a thousandth of
    the median leaf's (they move by round-off alone under AdamW).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import loss as ref_loss
from portbench.reference import route as ref_route
from portbench.reference.optim import BETAS, Optimizer
from portbench.reference.raft import RAFT

# the leaves whose reference gradient lies under this share of the median
# leaf's are left out of the change
STILL_LEAF = 1e-3


def read_pfm(path) -> np.ndarray:
    """A greyscale PFM as (h, w) float32."""
    with open(path, "rb") as f:
        if f.readline().rstrip() != b"Pf":
            raise ValueError(f"{path}: not a greyscale PFM")
        m = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, m.groups())
        endian = "<" if float(f.readline().rstrip()) < 0 else ">"
        data = np.fromfile(f, endian + "f")
    return np.flipud(data.reshape(height, width)).astype(np.float32)


def disparity_of_depth(depth: np.ndarray) -> np.ndarray:
    """Depth maps as the program writes them (0 where the disparity is 0)
    back to disparities."""
    d = depth.astype(np.float64)
    return np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))


def model_of(config: Dict, weights: Dict[str, torch.Tensor], dtype,
             test_mode: bool, device) -> RAFT:
    """The reference model of ``config`` in compute ``dtype`` with the
    benchmark's weights."""
    m = config["model"]
    model = RAFT(cascade=m["cascade"], encoder_type=m["encoder_type"],
                 dim_fmap=m["dim_fmap"], dim_net=m["dim_net"],
                 dim_inp=m["dim_inp"], test_mode=test_mode,
                 num_levels=m["num_levels"], radius=m["radius"],
                 hyp_chunk=m["hyp_chunk"], remat=m["remat"],
                 aggregation=m["aggregation"], dtype=dtype)
    model.load_state_dict({k: v.float() for k, v in weights.items()})
    return model.to(device)


def view_disparity(model: RAFT, images, poses, intrinsics, scale,
                   device) -> np.ndarray:
    """The reference's disparities (h, w) of one reference view with its
    neighbours, routed as the port routes one view under "auto"."""
    order, kind, key = ref_route.route_view(
        poses, intrinsics, scale, images.shape[1:3], model.stride_factor,
        model.fnet.conv2.out_channels)
    t = torch.as_tensor(np.ascontiguousarray(images[order]))[None]
    with torch.no_grad():
        out = model(t.to(device),
                    torch.as_tensor(poses[order])[None].to(device),
                    torch.as_tensor(intrinsics[order])[None].to(device),
                    torch.tensor([scale], device=device),
                    volume_fn=ref_route.volume_of(kind, key))
    return out[0].double().cpu().numpy()


def spacing(config: Dict) -> float:
    """The finest stage's hypothesis spacing (inverse-depth units): the
    unit the inference gaps are given in."""
    return min(0.0025 / n for _, n, _ in config["model"]["cascade"])


def view_gaps(program: np.ndarray, reference: np.ndarray, unit: float
              ) -> Dict[str, float]:
    """The widest and the root-mean-square gap between two disparity maps,
    in ``unit``s."""
    d = np.abs(program - reference) / unit
    return {"gap_max": float(d.max()),
            "gap_rms": float(np.sqrt((d * d).mean()))}


@contextlib.contextmanager
def precise():
    """fp32 matrix products and convolutions without TF32 (the flags
    restored on exit)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _to_device(batch, device):
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device, torch.float32)
            for k in ("images", "depths", "poses", "intrinsics")}


def disp_ground_truth(depths: torch.Tensor) -> torch.Tensor:
    d = depths[:, 0]
    return torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def reference_steps(config: Dict, weights: Dict[str, torch.Tensor],
                    batches: List[Dict], gws: List[float], device,
                    dtype=torch.float32, fault: Optional[str] = None
                    ) -> Dict:
    """The reference's train steps on ``batches`` from ``weights``:
    ``losses`` of each step, ``grad1`` each leaf's first gradient as the
    optimizer gets it (after the clip), ``raw1`` the same before the clip,
    ``change`` each leaf's change over the steps (CPU fp32 tensors).

    ``fault`` plants a fault in the reference's place: "half" drops the
    second half of each batch (the mean taken over the rest). The samples
    of a batch go through one at a time, each batch through the plan its
    whole keys to."""
    model = model_of(config, weights, dtype, False, device)
    model.train()
    opt = Optimizer(model.parameters(), config["train"]["num_steps"])
    router = ref_route.BatchRouter(model.stride_factor)
    before = {k: v.detach().float().cpu().clone()
              for k, v in model.named_parameters()}
    losses, grad1, raw1 = [], {}, {}
    for i, (batch, gw) in enumerate(zip(batches, gws)):
        key = router.key(batch)
        vol = ref_route.volume_of("rectified" if key is not None
                                  else "exact", key)
        B = len(batch["images"])
        # the loss is the mean of the samples' losses (each a mean over the
        # same number of pixels): one sample at a time, its gradient
        # accumulated, holds half the memory
        samples = range(max(1, B // 2) if fault == "half" else B)
        model.zero_grad(set_to_none=False)
        total = 0.0
        for b in samples:
            one = _to_device({k: np.asarray(v)[b:b + 1]
                              for k, v in batch.items()}, device)
            preds = model(one["images"], one["poses"], one["intrinsics"],
                          volume_fn=vol)
            loss, _ = ref_loss.sequence_loss(
                preds, disp_ground_truth(one["depths"]), float(gw))
            (loss / len(samples)).backward()
            total += float(loss.detach()) / len(samples)
            del preds, loss, one
        losses.append(total)
        if i == 0:
            raw1 = {k: p.grad.detach().float().cpu().clone()
                    for k, p in model.named_parameters()}
        opt.step()
        if i == 0:
            state = opt.adamw.state
            grad1 = {k: state[p]["exp_avg"].detach().float().cpu()
                     / (1.0 - BETAS[0])
                     for k, p in model.named_parameters()}
    change = {k: p.detach().float().cpu() - before[k]
              for k, p in model.named_parameters()}
    return {"losses": losses, "grad1": grad1, "raw1": raw1,
            "change": change}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm of the leaf or of the median leaf, whichever
    is larger."""
    norms = {k: float(ref[k].double().norm()) for k in leaves}
    median = float(np.median(list(norms.values())))
    return [abs(float(prog[k].double().norm()) - norms[k])
            / max(norms[k], median, 1e-30) for k in leaves]


def worst_leaves(program: Dict, reference: Dict, top: int = 3
                 ) -> Dict[str, List]:
    """The leaves that read the largest gaps of the first gradient and of
    the change, with their gaps (what a reading of ``train_gaps`` comes
    from)."""
    out = {}
    for key in ("grad1", "change"):
        ref = reference[key]
        norms = {k: float(v.double().norm()) for k, v in ref.items()}
        median = float(np.median(list(norms.values())))
        gaps = {k: abs(float(program[key][k].double().norm()) - norms[k])
                / max(norms[k], median, 1e-30) for k in ref}
        out[key] = [[k, gaps[k]] for k in
                    sorted(gaps, key=gaps.get, reverse=True)[:top]]
    return out


def still_leaves(reference: Dict) -> List[str]:
    """The leaves whose reference gradient lies under ``STILL_LEAF`` of the
    median leaf's (left out of the change)."""
    raw = {k: float(v.double().norm()) for k, v in reference["raw1"].items()}
    median = float(np.median(list(raw.values())))
    return sorted(k for k, v in raw.items() if v < STILL_LEAF * median)


def train_gaps(program: Dict, reference: Dict) -> Dict[str, float]:
    """The three numbers compared for a training cell."""
    losses = max(abs(p - r) / max(abs(r), 1e-30)
                 for p, r in zip(program["losses"], reference["losses"]))
    leaves = sorted(reference["grad1"])
    still = set(still_leaves(reference))
    moving = [k for k in leaves if k not in still]
    grads = _leaf_gaps(program["grad1"], reference["grad1"], leaves)
    changes = _leaf_gaps(program["change"], reference["change"], moving)
    return {"loss_gap": losses,
            "grad_gap": max(grads), "change_gap": max(changes),
            "grad_median": float(np.median(grads)),
            "change_median": float(np.median(changes))}
