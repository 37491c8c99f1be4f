"""Feature / context encoders.

Architecture (module names follow the reference ``state_dict``):
  conv1 7x7 stride 2 (3->32) -> norm -> relu
  layer1: 2x ResidualBlock(32, stride 1)
  layer2: ResidualBlock(64, stride 2) + ResidualBlock(64)
  [layer3: ResidualBlock(128, stride 2) + ResidualBlock(128)  iff type=="LR"]
  conv2 1x1 -> output_dim
"HR" yields 1/4 resolution features, "LR" 1/8. The instance norm has no
affine parameters and is computed in fp32. Parameters are fp32; convolutions
run in the module's compute ``dtype`` (bfloat16 by default).

Public layout is channels-last, as in the JAX package: (..., H, W, 3) in,
(..., H/f, W/f, C) out. Convolutions see the same memory through a permuted
NCHW view (channels-last memory format), so no layout copies are made.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """Apply ``conv`` to an NHWC tensor in compute dtype; returns NHWC."""
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w, b, conv.stride,
                 conv.padding)
    return y.permute(0, 2, 3, 1)


def init_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """Kaiming-normal (fan_out, relu) weights and zero bias, drawn from
    ``generator``."""
    fan_out = conv.out_channels * conv.kernel_size[0] * conv.kernel_size[1]
    std = math.sqrt(2.0 / fan_out)
    with torch.no_grad():
        conv.weight.normal_(0.0, std, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) normalization over H, W of an NHWC tensor, in
    fp32; no affine parameters."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(-3, -2), keepdim=True,
                               correction=0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _norm(norm_fn: str):
    if norm_fn == "instance":
        return instance_norm
    if norm_fn == "none":
        return lambda x: x
    raise ValueError(f"unsupported norm_fn {norm_fn!r} (instance/none)")


class ResidualBlock(nn.Module):
    """Two 3x3 convs with an optional strided 1x1 downsample shortcut."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1):
        super().__init__()
        self.norm = _norm(norm_fn)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride))

    def forward(self, x, dtype):
        y = F.relu(self.norm(conv_nhwc(self.conv1, x, dtype)))
        y = F.relu(self.norm(conv_nhwc(self.conv2, y, dtype)))
        if self.downsample is not None:
            x = self.norm(conv_nhwc(self.downsample[0], x, dtype))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """HR (1/4) or LR (1/8) residual encoder."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance",
                 type: str = "HR", dtype=torch.bfloat16):
        super().__init__()
        self.type = type
        self.dtype = dtype
        self.norm = _norm(norm_fn)
        dim = 32
        self.conv1 = nn.Conv2d(3, dim, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(dim, dim, norm_fn, 1),
                                    ResidualBlock(dim, dim, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(dim, 2 * dim, norm_fn, 2),
                                    ResidualBlock(2 * dim, 2 * dim, norm_fn, 1))
        last = 2 * dim
        if type == "LR":
            self.layer3 = nn.Sequential(
                ResidualBlock(2 * dim, 4 * dim, norm_fn, 2),
                ResidualBlock(4 * dim, 4 * dim, norm_fn, 1))
            last = 4 * dim
        self.conv2 = nn.Conv2d(last, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., H, W, 3) normalized images -> (..., H/f, W/f, output_dim)
        in the compute dtype."""
        batch_dims = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        dt = self.dtype
        x = F.relu(self.norm(conv_nhwc(self.conv1, x, dt)))
        layers = [self.layer1, self.layer2]
        if self.type == "LR":
            layers.append(self.layer3)
        for layer in layers:
            for block in layer:
                x = block(x, dt)
        x = conv_nhwc(self.conv2, x, dt)
        return x.reshape(batch_dims + x.shape[1:])
