"""The quad warp's wrapper and plain versions on the CPU
(``cermvs_torch/ops/quadwarp.py``): what the wrapper refuses, and the plain
transpose (``warp_image_backward_reference``, fp32 ``index_add_``) against
autograd through the plain forward (``warp_image_reference``), which the
CPU path of ``rectify.warp_image`` runs.

Tolerances: with an fp32 image the two transposes sum the same fp32 terms
in another order, so they agree to rtol 1e-5 / atol 1e-6 (a pixel takes
up to ~100 terms here, in the pile-up). With a bf16 image autograd rounds
each corner's share to bf16 and sums them in bf16, where the plain
transpose rounds its fp32 sum once: they agree to 2^-6 of the element's
sum of |terms| (a few bf16 roundings of terms of one sign). The kernels
are held against these plain versions on the card
(``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from cermvs_torch.ops import quadwarp as qw
from cermvs_torch.ops import rectify

H, W, C = 12, 17, 5


def positions(kind, rng, shape=(9, 11)):
    """Positions of one kind: inside the image, around and past its edges,
    on its last row and column, on integers, or piled on one pixel."""
    if kind == "inside":
        x = rng.uniform(0, W - 1, shape)
        y = rng.uniform(0, H - 1, shape)
    elif kind == "outside":
        x = rng.uniform(-6, W + 5, shape)
        y = rng.uniform(-6, H + 5, shape)
        x.reshape(-1)[:4] = [-1e4, 1e4, -1.0, W - 0.5]
    elif kind == "last_row_and_column":
        x = np.where(rng.rand(*shape) < 0.5, W - 1.0,
                     rng.uniform(W - 1.5, W - 0.5, shape))
        y = np.where(rng.rand(*shape) < 0.5, H - 1.0,
                     rng.uniform(H - 1.5, H - 0.5, shape))
    elif kind == "integers":
        x = rng.randint(-1, W + 1, shape).astype(np.float64)
        y = rng.randint(-1, H + 1, shape).astype(np.float64)
    elif kind == "pile_up":
        x = 4.0 + rng.uniform(0, 0.2, shape)
        y = 7.0 + rng.uniform(0, 0.2, shape)
    else:
        raise ValueError(kind)
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(y.astype(np.float32)))


KINDS = ["inside", "outside", "last_row_and_column", "integers", "pile_up"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["zero", "clamp"])
def test_backward_reference_equals_autograd(mode, dtype, kind):
    rng = np.random.RandomState(KINDS.index(kind))
    x, y = positions(kind, rng)
    img = torch.from_numpy(rng.randn(H, W, C).astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.randn(*x.shape, C).astype(np.float32))
    leaf = img.clone().requires_grad_(True)
    out = rectify.warp_image(leaf, x, y, mode=mode)
    torch.testing.assert_close(
        out, qw.warp_image_reference(img, x, y, mode), rtol=0, atol=0)
    out.backward(dout)
    ref = qw.warp_image_backward_reference(dout, x, y, (H, W, C), dtype,
                                           mode)
    assert ref.dtype == leaf.grad.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(leaf.grad, ref, rtol=1e-5, atol=1e-6)
    else:
        terms = qw.warp_image_backward_reference(dout.abs(), x, y, (H, W, C),
                                                 torch.float32, mode)
        err = (leaf.grad.float() - ref.float()).abs()
        assert bool((err <= 2.0 ** -6 * terms + 1e-30).all())
    assert float(ref.float().abs().max()) > 0 or kind == "outside"


def test_warp_image_takes_a_two_dimensional_image():
    rng = np.random.RandomState(7)
    x, y = positions("outside", rng)
    img = torch.from_numpy(rng.randn(H, W).astype(np.float32))
    torch.testing.assert_close(
        rectify.warp_image(img, x, y, mode="clamp"),
        qw.warp_image_reference(img[..., None], x, y, "clamp"), rtol=0,
        atol=0)


def refusal_cases():
    img = torch.zeros(H, W, C)
    x = torch.zeros(3, 4)
    meta = dict(device="meta")
    return {
        "device": (ValueError, (img.to(**meta), x.to(**meta), x.to(**meta)),
                   "unsupported device"),
        "mixed_devices": (ValueError, (img, x.to(**meta), x), "one device"),
        "img_dtype": (TypeError, (img.half(), x, x), "float32 or bfloat16"),
        "position_dtype": (TypeError, (img, x.double(), x), "float32"),
        "img_shape": (ValueError, (img[..., 0], x, x), "img"),
        "position_shapes": (ValueError, (img, x, x[:2]), "one shape"),
        "img_contiguity": (ValueError, (img.transpose(0, 1).contiguous()
                                        .transpose(0, 1), x, x),
                           "contiguous"),
        "position_contiguity": (ValueError, (img, x.t().contiguous().t(), x),
                                "contiguous"),
        "positions_require_grad": (ValueError, (
            img, x.clone().requires_grad_(True), x), "no gradient"),
        "empty_image": (ValueError, (img[:0], x, x), "non-empty"),
    }


@pytest.mark.parametrize("case", list(refusal_cases()))
def test_quad_warp_refuses(case):
    exc, args, match = refusal_cases()[case]
    with pytest.raises(exc, match=match):
        qw.quad_warp(*args)


def test_quad_warp_refuses_an_unknown_mode():
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="mode"):
        qw.quad_warp(torch.zeros(H, W, C), x, x, mode="reflect")


def test_quad_warp_refuses_a_counter_off_the_card():
    """The counter counts the kernel's blocks: the plain version has none
    to count."""
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="counter"):
        qw.quad_warp(torch.zeros(H, W, C), x, x,
                     counter=torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["zero", "clamp"])
def test_reached_pixels_counts_the_forwards_reads(mode, kind):
    """``reached_pixels`` is the number of distinct in-image corners (the
    pixels the forward reads, a zero weight's included), counted here in
    numpy, and ``work`` charges the forward for those pixels alone, the
    transpose for the whole image."""
    rng = np.random.RandomState(40 + KINDS.index(kind))
    x, y = positions(kind, rng)
    xs, ys = x.double().numpy(), y.double().numpy()
    if mode == "clamp":
        xs, ys = np.clip(xs, 0, W - 1), np.clip(ys, 0, H - 1)
    seen = {(int(r), int(q))
            for x0, y0 in zip(np.floor(xs).ravel(), np.floor(ys).ravel())
            for r in (y0, y0 + 1) for q in (x0, x0 + 1)
            if 0 <= r <= H - 1 and 0 <= q <= W - 1}
    n = qw.reached_pixels(x, y, (H, W), mode)
    assert n == len(seen)
    P = x.numel()
    full = qw.work(P, H, W, C, torch.bfloat16)
    part = qw.work(P, H, W, C, torch.bfloat16, pixels=n)
    assert full["quad_warp_fwd"] - part["quad_warp_fwd"] == (H * W - n) * C * 2
    assert part["quad_warp_bwd"] == full["quad_warp_bwd"]
