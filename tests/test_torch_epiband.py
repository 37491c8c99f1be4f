"""The epiband resample: the port's plain version against the JAX package's
Pallas kernel (run interpreted on the CPU, as the JAX package's own tests run
it), forward and backward, and the wrapper's argument checks. The CUDA
kernels against the plain versions: test_torch_cuda.py.

Tolerances: fp32 rtol 1e-4 / atol 1e-3 (the JAX kernel's own tolerance
against its oracle); bf16 features against the fp32 oracle rtol 0.05 /
atol 0.2 (bf16 rounding of the features, |G| ~ sqrt(C)); gradients rtol
1e-3 / atol 1e-3 (the JAX package's own VJP tolerance against its oracle's
gradient, test_rectified.py); bf16 gradients against JAX's bf16 gradients:
see test_backward_bf16_matches_jax_vjp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.ops.pallas.epiband import epiband_resample
from cermvs_torch.ops import cudalib
from cermvs_torch.ops import epiband as eb
from test_torch_cuda import CASES, H_R, S_MAX, V, W_R, inputs


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name,sig,base_rng,D,bounds", CASES,
                         ids=[c[0] for c in CASES])
def test_reference_matches_jax_kernel(rng, name, sig, base_rng, D, bounds):
    fr, fs, base, sigma = inputs(rng, base_rng or (0.0, 0.0), sig)
    static = base_rng is None
    out_j = epiband_resample(
        jnp.asarray(fr), jnp.asarray(fs), jnp.asarray(base),
        jnp.asarray(sigma), D, S_MAX, sigma_lo=sig[0] if bounds else 0.0,
        sigma_hi=sig[1] if bounds else None, static_base=static)
    out_p = eb.epiband(_t(fr), _t(fs), None if static else _t(base),
                       _t(sigma), D, S_MAX)
    assert out_p.shape == (V, H_R, W_R, D) and out_p.dtype == torch.float32
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-3)


def test_bf16_features_against_fp32(rng):
    ws, s_max = 256, 64
    fr, fs, base, sigma = inputs(rng, (-10.0, 40.0), (1.0, 3.0), ws=ws, v=1)
    ref = np.asarray(epiband_resample(
        jnp.asarray(fr), jnp.asarray(fs), jnp.asarray(base),
        jnp.asarray(sigma), 8, s_max, sigma_lo=1.0, sigma_hi=3.0))
    out = eb.epiband(_t(fr).to(torch.bfloat16), _t(fs).to(torch.bfloat16),
                     _t(base), _t(sigma), 8, s_max)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0.05, atol=0.2)


def test_wrapper_on_cpu_is_the_plain_version(rng):
    fr, fs, base, sigma = map(_t, inputs(rng, (-4.0, 40.0), (1.0, 3.0)))
    before = dict(cudalib.launches)
    out = eb.epiband(fr, fs, base, sigma, 8, S_MAX)
    assert cudalib.launches == before  # CPU tensors launch nothing
    assert torch.equal(out, eb.epiband_reference(fr, fs, base, sigma, 8,
                                                 S_MAX))
    zero = eb.epiband(fr, fs, None, sigma, 8, S_MAX)
    assert torch.equal(zero, eb.epiband(fr, fs, torch.zeros_like(base),
                                        sigma, 8, S_MAX))


def test_wrapper_rejects_mismatched_devices(rng):
    fr, fs, base, sigma = map(_t, inputs(rng, (-4.0, 40.0), (1.0, 3.0)))
    with pytest.raises(ValueError, match="one device"):
        eb.epiband(fr, fs, base, sigma.to("meta"), 8, S_MAX)


def test_wrapper_rejects_non_contiguous(rng):
    fr, fs, base, sigma = map(_t, inputs(rng, (-4.0, 40.0), (1.0, 3.0)))
    fr_nc = fr.transpose(1, 2).contiguous().transpose(1, 2)
    assert not fr_nc.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        eb.epiband(fr_nc, fs, base, sigma, 8, S_MAX)


@pytest.mark.parametrize("bad", ["dtype", "shape", "sigma_dtype"])
def test_wrapper_rejects_bad_arguments(rng, bad):
    fr, fs, base, sigma = map(_t, inputs(rng, (-4.0, 40.0), (1.0, 3.0)))
    if bad == "dtype":
        fr = fr.double()
    elif bad == "shape":
        fs = fs[:, :4].contiguous()
    else:
        sigma = sigma.double()
    with pytest.raises((TypeError, ValueError)):
        eb.epiband(fr, fs, base, sigma, 8, S_MAX)


def _offset_by_one(t):
    """A contiguous view of t's values that starts one element into its
    storage, so its rows are not 2-element aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.storage_offset() == 1
    return view


@pytest.mark.parametrize("bad", ["fr_misaligned_f32", "fs_misaligned_bf16",
                                 "offset_base_sigma_pass", "odd_channels",
                                 "too_wide"])
def test_kernel_argument_checks(rng, bad):
    """The checks the wrapper makes before a launch (the kernel reads fr/fs
    rows as 2-element vectors, one channel pair per lane)."""
    fr, fs, base, sigma = map(_t, inputs(rng, (-4.0, 40.0), (1.0, 3.0)))
    eb._check_kernel_args(fr, fs, base, sigma)  # the aligned inputs pass
    if bad == "fr_misaligned_f32":
        fr, match = _offset_by_one(fr), "fr must start on a 8-byte"
    elif bad == "fs_misaligned_bf16":
        fr, fs = fr.to(torch.bfloat16), _offset_by_one(fs.to(torch.bfloat16))
        match = "fs must start on a 4-byte"
    elif bad == "offset_base_sigma_pass":
        # fp32 views are always 4-byte aligned: base/sigma pass
        base, sigma, match = _offset_by_one(base), _offset_by_one(sigma), None
    elif bad == "odd_channels":
        fr, fs, match = fr[..., :7].contiguous(), fs[..., :7].contiguous(), \
            "even channel count"
    else:
        fr, fs = fr.repeat(1, 1, 1, 9), fs.repeat(1, 1, 1, 9)
        match = "even channel count <= 64"
    if match is None:
        eb._check_kernel_args(fr, fs, base, sigma)
    else:
        with pytest.raises(ValueError, match=match):
            eb._check_kernel_args(fr, fs, base, sigma)


def _jax_grads(fr, fs, base, sigma, cot, D, static, sig):
    """JAX epiband_resample's gradient in all four inputs (interpreted)."""
    def loss(a, b, c, d):
        return jnp.sum(epiband_resample(
            a, b, c, d, D, S_MAX, sigma_lo=sig[0], sigma_hi=sig[1],
            static_base=static) * cot)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (fr, fs, base, sigma)))


def test_backward_is_not_silently_the_plain_gradient(rng):
    """The port's backward is the JAX kernels' VJP, not autograd through the
    plain version: the same dfr/dfs, and no gradient for base and sigma
    where the JAX VJP gives exact zeros (autograd of the plain version gives
    base a non-zero one)."""
    fr, fs, base, sigma = inputs(rng, (-4.0, 40.0), (1.0, 3.0))
    D = 8
    cot = rng.randn(V, H_R, W_R, D).astype(np.float32)
    gj = _jax_grads(fr, fs, base, sigma, cot, D, False, (1.0, 3.0))
    assert float(jnp.abs(gj[2]).max()) == 0.0
    assert float(jnp.abs(gj[3]).max()) == 0.0
    t = [_t(a).requires_grad_(True) for a in (fr, fs, base, sigma)]
    (eb.epiband(*t, D, S_MAX) * _t(cot)).sum().backward()
    for a, b in zip(t[:2], gj[:2]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-3)
    assert t[2].grad is None and t[3].grad is None
    tp = [_t(a).requires_grad_(True) for a in (fr, fs, base, sigma)]
    (eb.epiband_reference(*tp, D, S_MAX) * _t(cot)).sum().backward()
    assert float(tp[2].grad.abs().max()) > 0.0


@pytest.mark.parametrize("name,sig,base_rng,D,bounds", CASES,
                         ids=[c[0] for c in CASES])
def test_backward_matches_jax_vjp(rng, name, sig, base_rng, D, bounds):
    """dfr and dfs of the port's plain backward against JAX's backward
    kernels, on the cases of the forward test: slabs partly and wholly out
    of the band, narrow and wide sigma, static (base == 0) and dynamic
    base."""
    fr, fs, base, sigma = inputs(rng, base_rng or (0.0, 0.0), sig)
    static = base_rng is None
    cot = rng.randn(V, H_R, W_R, D).astype(np.float32)
    gj = _jax_grads(fr, fs, base, sigma, cot, D, static,
                    sig if bounds else (0.0, None))
    dfr, dfs = eb.epiband_backward(_t(fr), _t(fs),
                                   None if static else _t(base), _t(sigma),
                                   _t(cot), S_MAX)
    assert dfr.dtype == dfs.dtype == torch.float32
    np.testing.assert_allclose(dfr.numpy(), np.asarray(gj[0]), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(dfs.numpy(), np.asarray(gj[1]), rtol=1e-3,
                               atol=1e-3)
    assert float(jnp.abs(gj[2]).max()) == float(jnp.abs(gj[3]).max()) == 0.0


@pytest.mark.parametrize("name,sig,base_rng,D,bounds", CASES,
                         ids=[c[0] for c in CASES])
def test_backward_bf16_matches_jax_vjp(rng, name, sig, base_rng, D, bounds):
    """With bf16 features the port's backward rounds where JAX's backward
    kernels do (dout, each tap's weight times dout, dG), so dfr and dfs
    equal JAX's bit for bit but for a few elements (under 1%): a tap weight
    a few fp32 ulps apart (the two compute it in another order) can flip a
    bf16 rounding, of dG or of the result: rtol 1e-2 / atol 0.07 (the
    largest difference over these cases is 2^-4, on values up to ~18, where
    a bf16 step is 2^-4 or 2^-3). Keeping dout, the products and dG in fp32 instead makes 30-55% of the
    elements differ."""
    fr, fs, base, sigma = inputs(rng, base_rng or (0.0, 0.0), sig)
    static = base_rng is None
    cot = rng.randn(V, H_R, W_R, D).astype(np.float32)
    frb, fsb = _t(fr).bfloat16(), _t(fs).bfloat16()

    def loss(a, b):
        return jnp.sum(epiband_resample(
            a, b, jnp.asarray(base), jnp.asarray(sigma), D, S_MAX,
            sigma_lo=sig[0] if bounds else 0.0,
            sigma_hi=sig[1] if bounds else None, static_base=static) * cot)

    gj = jax.grad(loss, argnums=(0, 1))(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (frb, fsb)))
    got = eb.epiband_backward(frb, fsb, None if static else _t(base),
                              _t(sigma), _t(cot), S_MAX)
    for a, b in zip(got, gj):
        assert a.dtype == torch.bfloat16
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=0.07)
        assert np.mean(a != b) < 0.01


def test_backward_bf16_returns_feature_dtype(rng):
    fr, fs, base, sigma = inputs(rng, (-4.0, 40.0), (1.0, 3.0), v=1)
    cot = _t(rng.randn(1, H_R, W_R, 8).astype(np.float32))
    f32 = eb.epiband_backward(_t(fr), _t(fs), _t(base), _t(sigma), cot,
                              S_MAX)
    bf = eb.epiband_backward(_t(fr).bfloat16(), _t(fs).bfloat16(),
                             _t(base), _t(sigma), cot, S_MAX)
    for a, b in zip(bf, f32):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=0.05,
                                   atol=0.1)
    with pytest.raises(ValueError, match="dout"):
        eb.epiband_backward(_t(fr), _t(fs), _t(base), _t(sigma),
                            cot.double(), S_MAX)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_far_and_nan_bases_add_nothing(rng, dtype):
    """Pixels whose base is NaN or +-1e5 have no in-band tap: the plain
    backward gives them a zero dfr and takes nothing from them into dfs,
    exactly as if their dout were zero (the CUDA kernels skip them alike,
    test_torch_cuda.py)."""
    fr, fs, base, sigma = inputs(rng, (-4.0, 40.0), (0.5, 1.5))
    cot = rng.randn(V, H_R, W_R, 8).astype(np.float32)
    far = np.zeros(base.shape, bool)
    far[0, 0, ::3] = far[0, 1, ::5] = far[1, 2, ::4] = True
    base[0, 0, ::3], base[0, 1, ::5], base[1, 2, ::4] = 1e5, -1e5, np.nan
    quiet = cot.copy()
    quiet[far] = 0.0
    fr, fs = _t(fr).to(dtype), _t(fs).to(dtype)
    got = eb.epiband_backward(fr, fs, _t(base), _t(sigma), _t(cot), S_MAX)
    base[far] = 0.0
    want = eb.epiband_backward(fr, fs, _t(base), _t(sigma), _t(quiet), S_MAX)
    assert bool(got[0][torch.from_numpy(far)].eq(0).all())
    for a, b in zip(got, want):
        assert bool(a.isfinite().all())
        assert torch.equal(a, b)
