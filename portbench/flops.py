"""The benchmark's own arithmetic of work, from shapes alone, so that it
stays the same whatever a later change implements:

  * :func:`forward_flops`: the model's FLOPs of one forward, 2 a
    multiply-add: the feature encoder on every frame and the context
    encoder on the reference, each GRU iteration of every cascade stage
    (the correlation encoder, the gates, the delta head) and each stage's
    loop-invariant gate term, and the correlation as one multiply-add per
    channel for each (pixel, hypothesis, neighbour) of each stage.
    Elementwise work and gathers count nothing. A train step is three
    forwards (:func:`step_flops`), remat's recompute not counted.
  * :func:`epiband_bytes`: the bytes the rectified volume's row resample
    must move at a plan's shapes: each input read once, each output written
    once.
  * :func:`peaks`: the card's published peaks (``peaks.json``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def conv(out_h: int, out_w: int, cin: int, cout: int, k: int) -> int:
    return 2 * out_h * out_w * cin * cout * k * k


def _down(n: int) -> int:
    """A stride-2 convolution's output length (padding k // 2)."""
    return (n + 1) // 2


def encoder_flops(H: int, W: int, out_dim: int, kind: str = "HR") -> int:
    """One frame through the residual encoder (HR: 1/4 resolution)."""
    if kind != "HR":
        raise ValueError(f"encoder {kind!r} is not counted")
    h2, w2 = _down(H), _down(W)
    h4, w4 = _down(h2), _down(w2)
    return (conv(h2, w2, 3, 32, 7)
            + 4 * conv(h2, w2, 32, 32, 3)          # layer1: two blocks
            + conv(h4, w4, 32, 64, 3) + conv(h4, w4, 64, 64, 3)
            + conv(h4, w4, 32, 64, 1)              # layer2, block 1
            + 2 * conv(h4, w4, 64, 64, 3)          # layer2, block 2
            + conv(h4, w4, 64, out_dim, 1))


def iteration_flops(h: int, w: int, m: Dict) -> int:
    """One GRU iteration at feature resolution h x w."""
    cor = len(m["aggregation"]) * m["num_levels"] * (2 * m["radius"] + 1)
    hn = m["dim_net"]
    dyn_in = hn + 49 + 64                          # net, disparity context,
    return (conv(h, w, cor, 64, 1) + conv(h, w, 64, 64, 3)   # corr encoding
            + conv(h, w, dyn_in, 2 * hn, 3) + conv(h, w, dyn_in, hn, 3)
            + conv(h, w, hn, 256, 3) + conv(h, w, 256, 1, 3))


def stage_ctx_flops(h: int, w: int, m: Dict) -> int:
    """A stage's loop-invariant gate term of the context features."""
    return conv(h, w, m["dim_inp"], 3 * m["dim_net"], 3)


def hypotheses(n: int, m: Dict) -> int:
    return (2 * m["radius"] + 1) * 2 ** (m["num_levels"] - 1) if n == -1 \
        else n


def correlation_flops(h: int, w: int, views: int, m: Dict) -> int:
    return sum(2 * m["dim_fmap"] * h * w * hypotheses(d, m) * views
               for d, _, _ in m["cascade"])


def forward_flops(m: Dict, frames: int, H: int, W: int) -> int:
    """One reference view with ``frames - 1`` neighbours at H x W."""
    h, w = H // 4, W // 4
    iters = sum(t for _, _, t in m["cascade"])
    return (frames * encoder_flops(H, W, m["dim_fmap"], m["encoder_type"])
            + encoder_flops(H, W, m["dim_net"] + m["dim_inp"],
                            m["encoder_type"])
            + iters * iteration_flops(h, w, m)
            + len(m["cascade"]) * stage_ctx_flops(h, w, m)
            + correlation_flops(h, w, frames - 1, m))


def step_flops(m: Dict, batch: int, frames: int, H: int, W: int) -> int:
    return 3 * batch * forward_flops(m, frames, H, W)


def epiband_bytes(h_r: int, w_r: int, ws: int, C: int, D: int,
                  feature_bytes: int, with_base: bool) -> Dict[str, int]:
    """Bytes of one launch on one view: the forward reads the reference
    rows (h_r, w_r, C) and the source band (h_r, ws, C), the rate (and the
    base) and writes the fp32 volume (h_r, w_r, D); each gradient reads the
    other side's rows, the rate, the base and the volume's gradient and
    writes its own side once."""
    fr = h_r * w_r * C * feature_bytes
    fs = h_r * ws * C * feature_bytes
    params = h_r * w_r * 4 * (2 if with_base else 1)
    vol = h_r * w_r * D * 4
    return {"epiband_fwd": fr + fs + params + vol,
            "epiband_bwd_dfr": fs + params + vol + fr,
            "epiband_bwd_dfs": fr + params + vol + fs}


def plan_epiband_bytes(plan, C: int, stages, feature_bytes: int = 2,
                       views=None) -> Dict[str, int]:
    """Summed bytes of every epiband launch of one sample's forward (and
    of its gradients) through a plan: one launch a (view, stage); stage 0
    has no base (its slab starts at zero). ``plan``: h_r, w_r, ws_r, s_max
    and view_s_max; ``views``: the plan's views that run rectified (all by
    default); ``stages``: the hypotheses of each stage."""
    total: Dict[str, int] = {}
    for v in (range(len(plan.view_s_max)) if views is None else views):
        ws = plan.ws_r - (plan.s_max - plan.view_s_max[v])
        for s, D in enumerate(stages):
            for k, b in epiband_bytes(plan.h_r, plan.w_r, ws, C, D,
                                      feature_bytes, s > 0).items():
                total[k] = total.get(k, 0) + b
    return total


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named ``device_name`` (as
    ``torch.cuda.get_device_name`` gives it), or None for a card the table
    does not know."""
    table = json.loads(PEAKS.read_text())
    return table.get(device_name.removeprefix("NVIDIA ").strip())
