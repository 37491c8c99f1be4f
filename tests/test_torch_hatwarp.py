"""The hat resample along rows: the port's plain version against the JAX
package's Pallas kernel (``hatwarp.hat_resample_rows``, run interpreted on
the CPU), forward and gradient, and the two-pass warp built from it against
JAX's with both of its engines. The CUDA kernels against the plain
versions: test_torch_cuda.py.

Tolerances: fp32 forward and gradient rtol 1e-5 / atol 1e-5 (both compute
fp32 products of the same two taps, in another summation order); bf16
forward the same (bf16 weights times bf16 values are exact in fp32); bf16
gradient rtol 1e-2 / atol 1e-2 (it is returned in bf16, one bf16 rounding
of sums of order 1); warps rtol 1e-5 / atol 1e-4 (pixel-coordinate maps in
the hundreds, as test_torch_rectified.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.ops import rectify as jrect
from cermvs_tpu.ops.pallas.hatwarp import hat_resample_rows as j_hat
from cermvs_torch.ops import cudalib
from cermvs_torch.ops import hatwarp as hw
from cermvs_torch.ops import rectify as prect
from test_torch_rectified import SCENES, _pairs


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(rng, R=6, S=40, O=52, C=5):
    img = rng.randn(R, S, C).astype(np.float32)
    # positions inside, at the edges, outside and at the -1e4 sentinel
    pos = rng.uniform(-3.0, S + 2.0, (R, O)).astype(np.float32)
    pos[0, :4] = [-1e4, -1.0, 0.0, S - 1.0]
    pos[1, :3] = [-0.5, S - 0.5, 1e4]
    pos[2] = np.round(pos[2])  # integer positions: one tap of weight 1
    return img, pos


TOLS = {"float32": (1e-5, 1e-5, 1e-5, 1e-5),
        "bfloat16": (1e-5, 1e-5, 1e-2, 1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_gradient_match_jax_kernel(rng, dtype):
    rtol, atol, grtol, gatol = TOLS[dtype]
    img, pos = _inputs(rng)
    cot = rng.randn(6, 52, 5).astype(np.float32)
    jimg = jnp.asarray(img).astype(dtype)
    out_j, vjp = jax.vjp(lambda a, p: j_hat(a, p), jimg, jnp.asarray(pos))
    dimg_j, dpos_j = vjp(jnp.asarray(cot))
    assert float(jnp.abs(dpos_j).max()) == 0.0

    timg = _t(img).to(getattr(torch, dtype)).requires_grad_(True)
    tpos = _t(pos).requires_grad_(True)
    before = dict(cudalib.launches)
    out_p = hw.hat_resample_rows(timg, tpos)
    assert out_p.dtype == torch.float32 and out_p.shape == (6, 52, 5)
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               rtol=rtol, atol=atol)
    (out_p * _t(cot)).sum().backward()
    assert cudalib.launches == before  # CPU tensors: the plain versions
    assert timg.grad.dtype == timg.dtype
    np.testing.assert_allclose(timg.grad.float().numpy(),
                               np.asarray(dimg_j.astype(jnp.float32)),
                               rtol=grtol, atol=gatol)
    assert tpos.grad is None  # pos: no gradient, zero in JAX's VJP


def test_gradient_rounds_dout_to_bf16_for_bf16_images(rng):
    """The transposed resample rounds dout to the image's bf16 before its
    products, as the JAX kernel does: a dout that differs below bf16's
    precision gives the same gradient."""
    img, pos = _inputs(rng)
    g = rng.randn(6, 52, 5).astype(np.float32)
    g_bf = _t(g).bfloat16().float()
    a = hw.hat_rows_backward(g_bf, _t(pos), 40, torch.bfloat16)
    b = hw.hat_rows_backward(g_bf * (1 + 2.0 ** -12), _t(pos), 40,
                             torch.bfloat16)
    assert torch.equal(a, b)
    exact = hw.hat_rows_backward(g_bf, _t(pos), 40, torch.float32)
    np.testing.assert_allclose(a.float().numpy(), exact.numpy(), rtol=1e-2,
                               atol=1e-2)


def test_plain_version_chunks_rows(rng, monkeypatch):
    img, pos = (_t(a) for a in _inputs(rng))
    full = hw.hat_resample_rows_reference(img, pos)
    g = torch.randn(6, 52, 5, generator=torch.Generator().manual_seed(0))
    dfull = hw.hat_resample_rows_backward_reference(g, pos, 40,
                                                    torch.float32)
    monkeypatch.setattr(hw, "HAT_BUDGET", 1)
    assert hw._row_chunk(6, 40, 52) == 1
    torch.testing.assert_close(hw.hat_resample_rows_reference(img, pos), full)
    torch.testing.assert_close(
        hw.hat_resample_rows_backward_reference(g, pos, 40, torch.float32),
        dfull)


@pytest.mark.parametrize("bad", ["img_dim", "rows", "dtype", "pos_dtype",
                                 "device", "contiguous"])
def test_wrapper_rejects_bad_arguments(rng, bad):
    img, pos = (_t(a) for a in _inputs(rng))
    if bad == "img_dim":
        img = img[0]
    elif bad == "rows":
        pos = pos[:4]
    elif bad == "dtype":
        img = img.double()
    elif bad == "pos_dtype":
        pos = pos.double()
    elif bad == "device":
        pos = pos.to("meta")
    else:
        img = img.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        hw.hat_resample_rows(img, pos)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_image_twopass_matches_jax_engines(rng, engine, dtype):
    """The port's two-pass warp (two hat resamples, tmp rounded to the
    compute dtype between them) against JAX's materialized-hat ("xla") and
    kernel ("pallas") engines, forward and image gradient."""
    make, lam = SCENES["general"]
    poses, intr, h, w = make()
    plan = prect.plan_rectification(poses, intr, h, w, lambda_max=lam)
    ii, jj = _pairs(poses.shape[1])
    geo = jrect.rect_geometry(jnp.asarray(poses), jnp.asarray(intr), ii, jj,
                              h, w, plan)
    H_inv = geo["H_src_inv"][-1]
    oh, ow = plan.h_r, plan.ws_r
    img = rng.randn(h, w, 6).astype(np.float32)
    cot = rng.randn(oh, ow, 6).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: jrect.warp_image_twopass(
        a, H_inv, oh, ow, engine=engine), jnp.asarray(img).astype(dtype))
    (g_j,) = vjp(jnp.asarray(cot))
    timg = _t(img).to(getattr(torch, dtype)).requires_grad_(True)
    out_p = prect.warp_image_twopass(timg, _t(np.asarray(H_inv)), oh, ow)
    (out_p * _t(cot)).sum().backward()
    assert np.abs(np.asarray(out_j)).max() > 0.1
    rtol, atol = (1e-5, 1e-4) if dtype == "float32" else (1e-2, 2e-2)
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(timg.grad.float().numpy(),
                               np.asarray(g_j.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
