"""Cascaded epipolar RAFT: the depth-regression network.

  * stages ``(D, N, T)``: D hypotheses (-1 -> ``(2r+1)*2^(levels-1)``),
    spacing ``incre = 0.0025 / N``, T GRU iterations;
  * stage 0 shifts the slab origin away from the zero init, later stages
    center it on the current estimate;
  * the disparity is detached at each iteration; predictions accumulate
    ``disp + delta``;
  * encoders and GRU compute in ``dtype`` (bfloat16 by default), the cost
    volume in fp32; with mean aggregation the view average is folded into the
    volume;
  * test mode returns the final disparity times ``scale``; train mode the
    per-iteration predictions (T_total, B, h, w).

Inputs use the JAX package's layouts: images (B, N, H, W, 3) in [0, 255],
poses (B, N, 4, 4) world-to-camera, intrinsics (B, N, 3, 3).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from cermvs_torch.config import configurable
from cermvs_torch.models.extractor import BasicEncoder, init_conv_
from cermvs_torch.models.update import UpdateBlock
from cermvs_torch.ops import corr as corr_ops


@configurable("RAFT")
class RAFT(nn.Module):
    def __init__(self,
                 cascade: Sequence[Tuple[int, int, int]] = ((64, 64, 8),
                                                            (-1, 320, 8)),
                 encoder_type: str = "HR", dim_fmap: int = 64,
                 dim_net: int = 64, dim_inp: int = 64,
                 test_mode: bool = False, num_levels: int = 3,
                 radius: int = 5, hyp_chunk: int = 16,
                 lookup_impl: str = "banded",
                 aggregation: Sequence[str] = ("mean",),
                 force_per_view_volumes: bool = False,
                 dtype=torch.bfloat16, volume_fn=None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        """``generator``: the CPU generator the weights are drawn from (seed 0
        when None); ``device``: where the module lives after init."""
        super().__init__()
        self.cascade = tuple(tuple(s) for s in cascade)
        self.encoder_type = encoder_type
        self.dim_fmap = dim_fmap
        self.dim_net = dim_net
        self.dim_inp = dim_inp
        self.test_mode = test_mode
        self.num_levels = num_levels
        self.radius = radius
        self.hyp_chunk = hyp_chunk
        self.lookup_impl = lookup_impl
        self.aggregation = tuple(aggregation)
        self.force_per_view_volumes = force_per_view_volumes
        self.dtype = dtype
        self.volume_fn = volume_fn
        self.fnet = BasicEncoder(dim_fmap, "instance", encoder_type, dtype)
        self.cnet = BasicEncoder(dim_net + dim_inp, "none", encoder_type,
                                 dtype)
        self.update_block = UpdateBlock(
            self.cascade, dim_net=dim_net, dim_inp=dim_inp,
            num_levels=num_levels, radius=radius,
            aggregation=self.aggregation, dtype=dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv_(m, generator)
        self.to(device)

    @property
    def mean_volume(self) -> bool:
        return self.aggregation == ("mean",) and not self.force_per_view_volumes

    @property
    def stride_factor(self) -> int:
        return 8 if self.encoder_type == "LR" else 4

    def auto_hyps(self, n: int) -> int:
        if n == -1:
            return (2 * self.radius + 1) * 2 ** (self.num_levels - 1)
        return n

    def _encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """All frames in one batch; frames above ~2.1 Mpx one at a time (the
        batch's activations would dominate device memory)."""
        H, W = frames.shape[1:3]
        if H * W <= 2_100_000:
            return self.fnet(frames)
        return torch.cat([self.fnet(f[None]) for f in frames], 0)

    def forward(self, images, poses, intrinsics, scale=None, volume_fn=None):
        """``volume_fn``: a volume construction for this call (default: the
        module's own, else the exact construction)."""
        B, N, H, W, _ = images.shape
        factor = self.stride_factor
        h, w = H // factor, W // factor
        V = N - 1
        dev = images.device

        poses = poses.float().clone()
        if scale is not None:
            scale = torch.as_tensor(scale, dtype=torch.float32,
                                    device=dev).reshape(B, 1, 1)
            poses[..., :3, 3] = poses[..., :3, 3] * scale
        intrinsics = intrinsics.float().clone()
        intrinsics[:, :, :2] = intrinsics[:, :, :2] / float(factor)
        images = images.float() * (2.0 / 255.0) - 1.0

        ii = torch.zeros(V, dtype=torch.int64, device=dev)
        jj = torch.arange(1, N, dtype=torch.int64, device=dev)

        # the named ranges show up in torch.profiler traces
        with record_function("raft.encoders"):
            net_inp = self.cnet(images[:, 0])
            net = torch.tanh(net_inp[..., :self.dim_net])
            inp = torch.relu(net_inp[..., self.dim_net:])
            fmaps = self._encode_frames(images.reshape(B * N, H, W, 3))
            fmaps = fmaps.reshape(B, N, h, w, -1).float()

        vol_fn = volume_fn or self.volume_fn or corr_ops.ExactVolume()
        with record_function("raft.volume_prepare"):
            vctx = vol_fn.prepare(fmaps, poses, intrinsics, ii, jj,
                                   self.dtype)

        disp = torch.zeros((B, h, w, 1), dtype=torch.float32, device=dev)
        predictions = []
        Vv = 1 if self.mean_volume else V
        for stage, (n_hyp, n_div, n_iters) in enumerate(self.cascade):
            n_hyp = self.auto_hyps(n_hyp)
            incre = 0.0025 / n_div
            with record_function(f"raft.volume_stage{stage}"):
                pyr = corr_ops.build_corr_pyramid(
                    vol_fn, vctx, disp.detach()[..., 0][:, None], n_hyp,
                    incre, shift=(stage == 0), num_levels=self.num_levels,
                    hyp_chunk=self.hyp_chunk,
                    mean_over_views=self.mean_volume, zero_slab=(stage == 0))
            with record_function(f"raft.iterations_stage{stage}"):
                g_ctx = self.update_block.gru_ctx(inp, stage)
                for _ in range(n_iters):
                    disp = disp.detach()
                    zinv = disp[..., 0][:, None].expand(B, Vv, h, w)
                    corr_frames = corr_ops.lookup(pyr, zinv, self.radius,
                                                  impl=self.lookup_impl)
                    net, delta = self.update_block(
                        net, inp, disp, corr_frames, stage, gru_ctx=g_ctx)
                    disp = disp + delta
                    predictions.append(disp)

        if self.test_mode:
            out = disp[..., 0]
            if scale is not None:
                out = out * scale
            return out
        return torch.stack([p[..., 0] for p in predictions], 0)
