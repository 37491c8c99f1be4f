"""Feature / context encoders.

Architecture (module names follow the reference ``state_dict``):
  conv1 7x7 stride 2 (3->32) -> norm -> relu
  layer1: 2x ResidualBlock(32, stride 1)
  layer2: ResidualBlock(64, stride 2) + ResidualBlock(64)
  [layer3: ResidualBlock(128, stride 2) + ResidualBlock(128)  iff type=="LR"]
  conv2 1x1 -> output_dim
"HR" yields 1/4 resolution features, "LR" 1/8. The instance and group
norms have no affine parameters and are computed in fp32. Parameters are
fp32; convolutions run in the module's compute ``dtype`` (bfloat16 by
default).

Public layout is channels-last, as in the JAX package: (..., H, W, 3) in,
(..., H/f, W/f, C) out. Convolutions see the same memory through a permuted
NCHW view (channels-last memory format), so no layout copies are made.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

# the compute dtypes a module takes by name; "float8" is the control's:
# every value the program rounds to its compute dtype is rounded to
# float8_e4m3fn under a per-tensor scale instead, and kept in fp32
FP8 = "float8"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, FP8: FP8}
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def compute_dtype(dtype):
    """``dtype`` as a torch dtype (or :data:`FP8`): given as one, or by a
    name of :data:`DTYPES`."""
    if isinstance(dtype, torch.dtype) or dtype == FP8:
        return dtype
    if isinstance(dtype, str) and dtype in DTYPES:
        return DTYPES[dtype]
    raise ValueError(f"dtype must be a torch dtype or one of "
                     f"{sorted(DTYPES)}, got {dtype!r}")


def storage(dtype) -> torch.dtype:
    """The torch dtype values of compute dtype ``dtype`` are held in."""
    return torch.float32 if dtype == FP8 else dtype


def _scaled_round(x: torch.Tensor, fmt, fmt_max: float) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under the scale that maps its largest
    magnitude to ``fmt_max``, back in fp32."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / fmt_max, torch.ones_like(amax))
    return (x / scale).to(fmt).float() * scale


class _Fp8Round(torch.autograd.Function):
    """fp8 training's rounding: values to float8_e4m3fn, their gradients
    to float8_e5m2, each under a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x.float(), torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g.float(), torch.float8_e5m2, 57344.0)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn under the scale that maps its largest
    magnitude to the format's largest value, in fp32; its gradient rounded
    to float8_e5m2 the same way."""
    return _Fp8Round.apply(x)


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in compute dtype ``dtype`` (:func:`fp8_round` for
    :data:`FP8`)."""
    return fp8_round(x) if dtype == FP8 else x.to(dtype)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """Apply ``conv`` to an NHWC tensor in compute dtype; returns NHWC."""
    w = cast(conv.weight, dtype)
    b = None if conv.bias is None else conv.bias.to(storage(dtype))
    y = F.conv2d(cast(x, dtype).permute(0, 3, 1, 2), w, b, conv.stride,
                 conv.padding)
    return y.permute(0, 2, 3, 1)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) normalization over H, W of an NHWC tensor, in
    fp32; no affine parameters."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(-3, -2), keepdim=True,
                               correction=0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def group_norm(x: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalization over H, W and each group of ``C // num_groups``
    channels of an NHWC tensor, in fp32; no affine parameters."""
    B, H, W, C = x.shape
    x32 = x.float().reshape(B, H, W, num_groups, C // num_groups)
    var, mean = torch.var_mean(x32, dim=(1, 2, 4), keepdim=True,
                               correction=0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return out.reshape(B, H, W, C).to(x.dtype)


def _norm(norm_fn: str, planes: int = 32):
    """The norm of a layer of ``planes`` channels. The group norm takes
    ``planes // 8`` groups; the encoder's stem passes no ``planes``, so its
    group norm has 4 groups whatever its width, as in the JAX package."""
    if norm_fn == "instance":
        return instance_norm
    if norm_fn == "group":
        return functools.partial(group_norm, num_groups=max(1, planes // 8))
    if norm_fn == "none":
        return lambda x: x
    raise ValueError(f"unsupported norm_fn {norm_fn!r} (instance/group/none)")


class ResidualBlock(nn.Module):
    """Two 3x3 convs with an optional strided 1x1 downsample shortcut."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1):
        super().__init__()
        self.norm = _norm(norm_fn, planes)
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
        self.dtype = compute_dtype(dtype)
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
