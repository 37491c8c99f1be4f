"""The port's FLOP count (cermvs_torch/utils/flops.py) against a walk of the
JAX package's jaxprs on the CPU.

The walk counts what the port's counter counts: every ``conv_general_dilated``
and ``dot_general`` equation as 2 FLOPs a multiply-add, the body of a scan
times its length, and nothing of a ``pallas_call`` (the port counts its
kernels by their ``work`` formulas instead). The encoders and an update
iteration are convolutions only, and equal exactly. The whole forward
differs where the two packages compute the same thing in different forms;
each difference is named below and held to its formula exactly.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import source_info_util
from jax.extend import core as jcore
from torch.utils.flop_counter import FlopCounterMode

from cermvs_tpu.models.extractor import BasicEncoder as JEncoder
from cermvs_tpu.models.update import UpdateBlock as JUpdateBlock
from cermvs_tpu.pipeline.inference import InferenceRunner as JRunner
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops import epiband as eb
from cermvs_torch.ops import hatwarp as hw
from cermvs_torch.ops import lookup as lk
from cermvs_torch.pipeline.inference import InferenceRunner
from cermvs_torch.utils import flops
from cermvs_torch.utils.flops import (CaptureError, count_flops,
                                      device_peak_flops, flops_of, mfu)
from test_torch_slice import CASCADE, _scene


# ---- JAX's flops tests, for the port -----------------------------------

def test_matmul_flop_count():
    a = torch.ones(128, 128)
    assert flops_of(lambda x, y: (x @ y).sum(), a, a) == 2 * 128 ** 3


def test_python_scalar_args_supported():
    a = torch.ones(64, 64)
    assert flops_of(lambda x, s: (x @ x).sum() * s, a, 0.5) == 2 * 64 ** 3


def test_peak_table_and_mfu(monkeypatch):
    names = {0: "NVIDIA H100 80GB HBM3", 1: "NVIDIA H100 PCIe"}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: names[torch.device(d).index])
    assert device_peak_flops("cuda:0") == 989e12
    assert abs(mfu(989e12, 1.0, "cuda:0") - 1.0) < 1e-9
    assert device_peak_flops("cuda:1") is None  # the full name decides
    assert device_peak_flops("cpu") is None
    assert mfu(1e9, 1.0, "cpu") is None


def test_flops_of_unrunnable_returns_none():
    assert flops_of(lambda x: x + 1, object()) is None


def test_count_refuses_a_capture(monkeypatch):
    """The formulas read data: a count inside a CUDA graph capture raises,
    also through flops_of, and so does a kernel wrapper reached while a
    count is open."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(CaptureError):
        count_flops(lambda: None)
    with pytest.raises(CaptureError):
        flops_of(lambda: None)
    monkeypatch.setattr(flops, "_capturing", lambda: False)
    img, pos = torch.zeros(2, 5, 4), torch.zeros(2, 3)

    def capture_inside():
        monkeypatch.setattr(flops, "_capturing", lambda: True)
        hw.hat_resample_rows(img, pos)

    with pytest.raises(CaptureError):
        count_flops(capture_inside)


# ---- each kernel wrapper: its formula, and nothing of its plain version ----

def _epiband_inputs(rng, with_base, dtype):
    V, h_r, w_r, ws, C, D = 2, 3, 24, 40, 16, 8
    fr = torch.from_numpy(rng.randn(V, h_r, w_r, C).astype(np.float32))
    fs = torch.from_numpy(rng.randn(V, h_r, ws, C).astype(np.float32))
    sigma = torch.from_numpy(rng.uniform(0.5, 2.0, (V, h_r, w_r))
                             .astype(np.float32))
    base = (torch.from_numpy(rng.uniform(-8, 30, (V, h_r, w_r))
                             .astype(np.float32)) if with_base else None)
    return fr.to(dtype), fs.to(dtype), base, sigma, D, 12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_base", [False, True])
def test_epiband_counts_its_formula(rng, with_base, dtype):
    fr, fs, base, sigma, D, s_max = _epiband_inputs(rng, with_base, dtype)
    # the plain version alone is products the counter sees
    plain = FlopCounterMode(display=False)
    with plain:
        eb.epiband_reference(fr, fs, base, sigma, D, s_max)
    assert plain.get_total_flops() > 0
    fr.requires_grad_(True)
    fs.requires_grad_(True)
    c = count_flops(lambda: eb.epiband(fr, fs, base, sigma, D, s_max)
                    .sum().backward())
    w = eb.work(fr, fs, base, sigma, D, s_max)
    assert c.aten_total == 0
    assert c.kernels == {k: w[k][1] for k in eb.KERNELS}
    assert c.calls == {k: 1 for k in eb.KERNELS}
    taps = c.kernels["epiband_bwd_dfr"] // (2 * fr.shape[-1])
    assert 0 < taps < 2 * fr.shape[0] * fr.shape[1] * fr.shape[2] * D
    assert c.kernels["epiband_fwd"] == (c.kernels["epiband_bwd_dfs"]
                                        + 4 * sigma.numel() * D)
    with torch.no_grad():
        c = count_flops(eb.epiband, fr, fs, base, sigma, D, s_max)
    assert c.kernels == {"epiband_fwd": w["epiband_fwd"][1]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hat_counts_its_formula(rng, dtype):
    R, S, O, C = 6, 20, 14, 8
    img = torch.from_numpy(rng.randn(R, S, C).astype(np.float32)).to(dtype)
    pos = torch.from_numpy(rng.uniform(-3, S + 2, (R, O)).astype(np.float32))
    plain = FlopCounterMode(display=False)
    with plain:
        hw.hat_resample_rows_reference(img, pos)
    assert plain.get_total_flops() == 2 * R * S * O * C  # dense
    img.requires_grad_(True)
    c = count_flops(lambda: hw.hat_resample_rows(img, pos).sum().backward())
    w = hw.work(pos, S, C, dtype)
    assert c.aten_total == 0
    assert c.kernels == {k: w[k][1] for k in hw.KERNELS}
    fl = np.floor(pos.numpy())
    taps = ((fl >= 0) & (fl <= S - 1)).sum() + ((fl >= -1)
                                                 & (fl <= S - 2)).sum()
    assert c.kernels["hat_rows_fwd"] == 2 * C * taps < 2 * R * S * O * C


def test_lookup_counts_its_formula(rng):
    D = 24
    corr = torch.from_numpy(rng.randn(2, 1, 5, 7, D).astype(np.float32))
    x0 = torch.from_numpy(np.maximum(rng.rand(2, 1, 5, 7) * (D + 16) - 4, 0)
                          .astype(np.float32))
    corr.requires_grad_(True)
    c = count_flops(lambda: lk.lookup_fused(corr, x0).sum().backward())
    w = lk.work(x0, D)
    assert c.aten_total == 0
    assert c.kernels == {"lookup_fused_fwd": w["lookup_fused_fwd"][1],
                         "lookup_fused_bwd": w["lookup_fused_bwd"][1]}
    with torch.no_grad():
        c = count_flops(lk.lookup_fused_v2, corr, x0)
    assert c.aten_total == 0
    assert c.kernels == {"lookup_fused_v2": w["lookup_fused_v2"][1]}
    assert w["lookup_fused_v2"] == w["lookup_fused_fwd"]


# ---- the JAX walk --------------------------------------------------------

def _site(eqn):
    """The innermost function of the JAX package that made ``eqn``."""
    for f in source_info_util.user_frames(eqn.source_info.traceback):
        if "cermvs_tpu" in f.file_name:
            return f.function_name
    return "?"


def _walk(jaxpr, mult=1, out=None):
    """FLOPs of the conv and dot equations of ``jaxpr`` by kind: "conv",
    and each dot by the function that made it; "pallas_call": the calls."""
    out = Counter() if out is None else out
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "pallas_call":
            out["pallas_call"] += mult
            continue
        if name == "conv_general_dilated":
            rhs = e.invars[1].aval.shape
            spec = e.params["dimension_numbers"].rhs_spec
            macs = rhs[spec[1]] * int(np.prod([rhs[i] for i in spec[2:]]))
            out["conv"] += mult * 2 * int(np.prod(e.outvars[0].aval.shape)) \
                * macs
        elif name == "dot_general":
            (_, rc), (_, rb) = e.params["dimension_numbers"]
            ls, rs = e.invars[0].aval.shape, e.invars[1].aval.shape
            free = int(np.prod([n for i, n in enumerate(rs)
                                if i not in rc and i not in rb]))
            out[_site(e)] += mult * 2 * int(np.prod(ls)) * free
        assert name not in ("while", "cond"), name  # no unknown trip count
        inner = mult * (e.params["length"] if name == "scan" else 1)
        for v in e.params.values():
            for x in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(x, jcore.ClosedJaxpr):
                    _walk(x.jaxpr, inner, out)
                elif isinstance(x, jcore.Jaxpr):
                    _walk(x, inner, out)
    return out


def _jax_count(fn, *args):
    return _walk(jax.make_jaxpr(fn)(*args).jaxpr)


@pytest.fixture(scope="module")
def port():
    return RAFT(cascade=CASCADE, dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("enc", ["fnet", "cnet"])
def test_encoders_count_the_jaxpr(port, enc):
    x = np.random.RandomState(0).randn(2, 40, 56, 3).astype(np.float32)
    dim, norm = (64, "instance") if enc == "fnet" else (128, "none")
    mod = JEncoder(dim, norm, "HR", jnp.float32)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = _jax_count(mod.apply, params, jnp.asarray(x))
    with torch.no_grad():
        c = count_flops(getattr(port, enc), torch.from_numpy(x))
    assert set(want) == {"conv"}
    assert c.aten == {"aten.convolution": want["conv"]}
    assert c.kernels == {}


@pytest.mark.parametrize("stage", [0, 1])
def test_update_iteration_counts_the_jaxpr(port, stage):
    """One GRU iteration as RAFT runs it (the context's gate terms hoisted
    out of the loop), and the hoisted terms themselves."""
    rng = np.random.RandomState(1)
    net = jnp.asarray(rng.randn(1, 6, 9, 64).astype(np.float32))
    inp = jnp.asarray(rng.rand(1, 6, 9, 64).astype(np.float32))
    disp = jnp.asarray((rng.rand(1, 6, 9, 1) * 0.01).astype(np.float32))
    corr = jnp.asarray(rng.randn(1, 3, 6, 9, 33).astype(np.float32))
    ub = JUpdateBlock(cascade=CASCADE, dtype=jnp.float32)
    params = ub.init(jax.random.PRNGKey(0), net, inp, disp, corr, 0)
    ctx = ub.apply(params, inp, stage, method=JUpdateBlock.gru_ctx)
    want_ctx = _jax_count(lambda p, i: ub.apply(
        p, i, stage, method=JUpdateBlock.gru_ctx), params, inp)
    want = _jax_count(lambda p, *a: ub.apply(p, *a, stage, gru_ctx=ctx),
                      params, net, inp, disp, corr)
    t = [torch.from_numpy(np.array(a)) for a in (net, inp, disp, corr)]
    blk = port.update_block
    with torch.no_grad():
        c_ctx = count_flops(blk.gru_ctx, t[1], stage)
        g = blk.gru_ctx(t[1], stage)
        c = count_flops(lambda: blk(*t, stage, gru_ctx=g))
    assert set(want) == set(want_ctx) == {"conv"}
    assert c_ctx.aten == {"aten.convolution": want_ctx["conv"]}
    assert c.aten == {"aten.convolution": want["conv"]}


# ---- the slice's whole forward -----------------------------------------

def _lookup_dots(B, V, h, w, stages, radius=5, levels=3):
    """JAX's banded lookup: per iteration and level, a dot of the K + 1
    pooled cells' lerp weights with each of the D_l cells of the band."""
    return sum(2 * B * V * h * w * (D >> lvl) * (2 * radius + 2) * iters
               for D, iters in stages for lvl in range(levels))


@pytest.mark.parametrize("construction", ["rectified", "exact"])
def test_slice_forward_against_the_walk(port, construction, monkeypatch):
    """The slice model's forward (test_torch_slice.py's scene and cascade,
    fp32): the convolutions equal; each other difference is named
    and held to its formula.

    * The lookup (both constructions): JAX contracts each level's band with
      its lerp weights by a ``dot_general`` (``corr.py`` ``_lookup_banded``);
      the port multiplies and sums elementwise, which the counter does not
      count. JAX's dots equal ``_lookup_dots`` exactly.
    * Rectified: JAX's two-pass warps on the CPU are dense hat-matrix
      products (``rectify.py`` ``warp_image_twopass``), 2 R S O C for each
      pass; the port's ``hat_rows`` kernel counts its in-range taps, at most
      2 of the S a position. JAX's dots equal the dense form of the port's
      passes exactly. The epiband volumes are kernels on both sides (one
      call a view and stage). The plan's geometry equals.
    * Exact: JAX's correlation is a ``dot_general`` over each stage's
      hypotheses padded to whole chunks of ``hyp_chunk`` and the four
      bilinear corners (``corr.py`` ``_gather_corr_chunk``); the port's is
      an elementwise product and sum. JAX projects the padded hypotheses too
      (``apply_projection``), so the port's projection is JAX's times the
      real over the padded hypotheses (52 of 64 here), and JAX forms the
      relative projections once a stage, the port once a forward."""
    images, poses, intr = _scene()
    params = convert_raft({k: v.numpy() for k, v in port.state_dict().items()})
    jr = JRunner(params, construction=construction, cascade=CASCADE,
                 dtype=jnp.float32, rect_lambda_max=0.1)
    im, po, k = images[None], poses[None], intr[None]
    model = jr.model
    if construction == "rectified":
        order = jr._neighbor_order(poses)
        im, po, k = (a[:, order] for a in (im, po, k))
        model, _ = jr._rect_model(po[0], k[0], 1.0, im[0].shape[1:3])
    want = _jax_count(lambda p, *a: model.apply(p, *a), params,
                      jnp.asarray(im), jnp.asarray(po), jnp.asarray(k),
                      jnp.ones(1, jnp.float32))

    passes = []
    work = hw.work

    def recorded(pos, S, C, dtype):
        passes.append((pos.shape[0], S, pos.shape[1], C))
        return work(pos, S, C, dtype)

    monkeypatch.setattr(hw, "work", recorded)
    pr = InferenceRunner(model=port, construction=construction,
                         rect_lambda_max=0.1, device="cpu")
    r = pr.route(images[None], poses[None], intr[None], [1.0])
    assert r.path == construction
    with torch.no_grad():
        c = count_flops(port, *r[:4], volume_fn=r.volume_fn)

    B, V, h, w = 1, 2, 16, 48
    stages = [(8, 2), (44, 2)]
    aten = dict(c.aten)
    assert aten.pop("aten.convolution") == want.pop("conv")
    geometry = sum(aten.values())
    assert want.pop("_lookup_banded") == _lookup_dots(B, 1, h, w, stages)
    if construction == "rectified":
        dense = sum(2 * R * S * O * C for R, S, O, C in passes)
        assert sum(v for s, v in want.items() if "warp_image_twopass" in s) \
            == dense
        assert c.kernels["hat_rows_fwd"] < dense
        assert c.calls == {"epiband_fwd": want.pop("pallas_call"),
                           "hat_rows_fwd": len(passes)}
        rest = {s: v for s, v in want.items()
                if "warp_image_twopass" not in s}
        assert geometry == sum(rest.values()) > 0
    else:
        assert c.kernels == {} and "pallas_call" not in want
        padded = sum(-(-D // port.hyp_chunk) * port.hyp_chunk
                     for D, _ in stages)
        assert want.pop("_gather_corr_chunk.<locals>.<lambda>") == 2 * B * V * h * w * 64 * 4 * padded
        real = sum(D for D, _ in stages)
        projection = want.pop("apply_projection")
        assert projection % padded == 0
        once = want.pop("relative_projection") + want.pop("inv_pose")
        assert not want
        assert geometry == projection // padded * real + once // len(stages)
