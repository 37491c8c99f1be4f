"""Iterative update operator: ConvGRU + correlation/disparity encoders.

Module names follow the reference ``state_dict`` (``update_block.gru.convz``,
``update_block.corr_encoder.0``, ``update_block.delta0.2``, ...).

  * ``cor_planes = len(aggregation) * num_levels * (2*radius+1)`` = 33 by
    default.
  * By default the corr encoder and the GRU are shared across cascade stages
    and each stage has its own delta head. ``share_corr``, ``share_gru`` and
    ``share_delta`` choose, for each, one module (``corr_encoder``, ``gru``,
    ``delta``) or one per stage (``corr_encoder0``, ``gru1``, ``delta0``,
    ...), under the names of the reference's checkpoints of each form.
  * Disparity context: 7x7 neighbourhood minus centre, scaled x100; the delta
    output is scaled x0.01.
  * Multi-view aggregation over the view axis: mean (default), max, std.

Public layouts are channels-last, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.extractor import (cast, compute_dtype,
                                           conv_nhwc, storage)


def _conv_w(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """Same-padding stride-1 conv of an NHWC tensor with weight w (O,I,k,k)."""
    p = w.shape[-1] // 2
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, 1, p).permute(0, 2, 3, 1)


class ConvGRU(nn.Module):
    """z/r/q convolutional gates over ``[net, inp, dyn]``.

    Parameters are three plain convs (``convz``, ``convr``, ``convq``). In
    application the z and r convs share one call (their weights are
    concatenated along the output channels), and the contribution of the
    ``static_planes`` context channels (constant across iterations) plus all
    three biases is computed once per stage by :meth:`ctx`.
    """

    def __init__(self, h_planes: int, static_planes: int, dyn_planes: int,
                 kernel: int = 3, dtype=torch.bfloat16):
        super().__init__()
        self.h_planes = h_planes
        self.static_planes = static_planes
        self.dtype = compute_dtype(dtype)
        cin = h_planes + static_planes + dyn_planes
        self.convz = nn.Conv2d(cin, h_planes, kernel, padding=kernel // 2)
        self.convr = nn.Conv2d(cin, h_planes, kernel, padding=kernel // 2)
        self.convq = nn.Conv2d(cin, h_planes, kernel, padding=kernel // 2)

    def _split(self, conv):
        h, s = self.h_planes, self.static_planes
        w = conv.weight
        return w[:, :h], w[:, h:h + s], w[:, h + s:]

    def ctx(self, inp_static: torch.Tensor) -> torch.Tensor:
        """Loop-invariant gate contributions: (B, H, W, 3*h_planes)."""
        dt = self.dtype
        convs = (self.convz, self.convr, self.convq)
        w = cast(torch.cat([self._split(c)[1] for c in convs], 0), dt)
        b = torch.cat([c.bias for c in convs]).to(storage(dt))
        return _conv_w(cast(inp_static, dt), w) + b

    def forward(self, net, dyn, ctx):
        """net (B,H,W,h); dyn (B,H,W,dyn_planes) per-iteration inputs
        (disparity context + corr encoding); ctx from :meth:`ctx`."""
        dt = self.dtype
        h = self.h_planes
        (zn, _, zd), (rn, _, rd), (qn, _, qd) = (
            self._split(c) for c in (self.convz, self.convr, self.convq))
        wzr = torch.cat([torch.cat([zn, zd], 1), torch.cat([rn, rd], 1)], 0)
        zr = torch.sigmoid(_conv_w(cast(torch.cat([net, dyn], -1), dt), cast(wzr, dt))
                           + ctx[..., :2 * h])
        z, r = zr[..., :h], zr[..., h:]
        wq = cast(torch.cat([qn, qd], 1), dt)
        q = torch.tanh(_conv_w(cast(torch.cat([r * net, dyn], -1), dt), wq)
                       + ctx[..., 2 * h:])
        return (1 - z) * net + z * q


def disp_context(disp: torch.Tensor, size: int = 7) -> torch.Tensor:
    """(B, H, W, 1) -> (B, H, W, size^2) neighbour-minus-centre disparities
    (zero padding, channel order (dy, dx) row-major)."""
    B, H, W, _ = disp.shape
    r = size // 2
    padded = F.pad(disp[..., 0], (r, r, r, r))
    shifts = [padded[:, dy:dy + H, dx:dx + W]
              for dy in range(size) for dx in range(size)]
    return torch.stack(shifts, dim=-1) - disp


def _two_conv(dim_in, dim0, dim1, k0, k1, final_relu):
    layers = [nn.Conv2d(dim_in, dim0, k0, padding=k0 // 2), nn.ReLU(),
              nn.Conv2d(dim0, dim1, k1, padding=k1 // 2)]
    if final_relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def _apply_two_conv(seq: nn.Sequential, x, dtype):
    """conv, relu, conv [, relu]."""
    x = F.relu(conv_nhwc(seq[0], x, dtype))
    x = conv_nhwc(seq[2], x, dtype)
    return F.relu(x) if len(seq) > 3 else x


class UpdateBlock(nn.Module):
    """Per-iteration update: corr encoding, view aggregation, GRU, delta head."""

    def __init__(self, cascade: Sequence[Tuple[int, int, int]],
                 dim_net: int = 64, dim_inp: int = 64, dim0_corr: int = 64,
                 dim1_corr: int = 64, kernel_corr: int = 3,
                 dim0_delta: int = 256, kernel0_delta: int = 3,
                 kernel1_delta: int = 3, num_levels: int = 3,
                 radius: int = 5, size_disp_enc: int = 7,
                 share_corr: bool = True, share_gru: bool = True,
                 share_delta: bool = False,
                 aggregation: Sequence[str] = ("mean",),
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.aggregation = tuple(aggregation)
        self.size_disp_enc = size_disp_enc
        self.cor_planes = len(self.aggregation) * num_levels * (2 * radius + 1)
        self.shared = {"corr_encoder": share_corr, "gru": share_gru,
                       "delta": share_delta}
        dyn = size_disp_enc ** 2 + dim1_corr
        make = {
            "corr_encoder": lambda: _two_conv(self.cor_planes, dim0_corr,
                                              dim1_corr, 1, kernel_corr, True),
            "gru": lambda: ConvGRU(dim_net, dim_inp, dyn, dtype=dtype),
            "delta": lambda: _two_conv(dim_net, dim0_delta, 1, kernel0_delta,
                                       kernel1_delta, False)}
        for name, shared in self.shared.items():
            for i in [""] if shared else range(len(cascade)):
                setattr(self, f"{name}{i}", make[name]())

    def stage_module(self, name: str, stage: int) -> nn.Module:
        """The ``corr_encoder``, ``gru`` or ``delta`` of cascade stage
        ``stage``: the shared module, or the stage's own."""
        return getattr(self, name if self.shared[name] else f"{name}{stage}")

    def gru_ctx(self, inp: torch.Tensor, stage: int) -> torch.Tensor:
        """Loop-invariant GRU gate contributions of the context features —
        computed once per cascade stage, by the stage's GRU."""
        return self.stage_module("gru", stage).ctx(inp)

    def aggregate(self, corr_frames: torch.Tensor) -> torch.Tensor:
        parts = []
        if "mean" in self.aggregation:
            parts.append(corr_frames.mean(dim=1))
        if "max" in self.aggregation:
            parts.append(corr_frames.amax(dim=1))
        if "std" in self.aggregation:
            parts.append(corr_frames.std(dim=1, correction=0))
        return torch.cat(parts, dim=-1)

    def forward(self, net, inp, disp, corr_frames, stage: int, gru_ctx=None):
        """net/inp: (B, H, W, dim); disp: (B, H, W, 1) fp32; corr_frames:
        (B, V, H, W, cor_planes) fp32. Returns (net, delta)."""
        dt = self.dtype
        dctx = cast(100.0 * disp_context(disp, self.size_disp_enc), dt)
        corr = cast(self.aggregate(corr_frames), dt)
        corr = _apply_two_conv(self.stage_module("corr_encoder", stage), corr,
                               dt)
        if gru_ctx is None:
            gru_ctx = self.gru_ctx(inp, stage)
        dyn = torch.cat([dctx, corr], dim=-1)
        net = self.stage_module("gru", stage)(cast(net, dt), dyn, gru_ctx)
        d = _apply_two_conv(self.stage_module("delta", stage), net, dt)
        return net, 0.01 * d.float()
