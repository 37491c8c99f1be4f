"""CUDA-only tests of the port: the epiband kernel against its plain
PyTorch version on the card, and the small end-to-end agreement of the
rectified (kernel) and exact constructions. They skip where
``torch.cuda.is_available()`` is false. This file imports nothing of JAX, so
it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

Tolerances: kernel against plain on the same tensors rtol 1e-4 / atol 1e-3
with fp32 features and rtol 1e-3 / atol 1e-2 with bf16 features (both
accumulate in fp32; only the summation order differs).
"""

import numpy as np
import pytest
import torch

from cermvs_torch.ops import epiband as eb

V, H_R, W_R, WS, C = 2, 8, 128, 224, 8
S_MAX = WS - W_R - 16

# (id, sigma range, base range or None for base == 0, D, bounded windows)
CASES = [
    ("bounded", (1.0, 3.0), (-4.0, 40.0), 8, True),
    ("full_window", (1.0, 3.0), (-4.0, 40.0), 8, False),
    ("out_of_band", (1.0, 3.0), (-60.0, 90.0), 8, True),
    ("narrow_sigma_stage1", (0.4, 0.7), (-10.0, 70.0), 16, True),
    ("static_base_d8", (1.0, 3.0), None, 8, True),
    ("static_base_d16", (0.4, 0.7), None, 16, True),
]




def inputs(rng, base_rng, sigma_rng, ws=WS, v=V):
    fr = rng.randn(v, H_R, W_R, C).astype(np.float32)
    fs = rng.randn(v, H_R, ws, C).astype(np.float32)
    base = rng.uniform(*base_rng, (v, H_R, W_R)).astype(np.float32)
    sigma = rng.uniform(*sigma_rng, (v, H_R, W_R)).astype(np.float32)
    return fr, fs, base, sigma


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 1e-3, 1e-2)])
@pytest.mark.parametrize("name,sig,base_rng,D,bounds", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda_device, dtype, rtol, atol, name, sig,
                              base_rng, D, bounds):
    rng = np.random.RandomState(0)
    fr, fs, base, sigma = inputs(rng, base_rng or (0.0, 0.0), sig)
    dev = cuda_device
    fr, fs = (torch.from_numpy(a).to(dev, dtype).contiguous()
              for a in (fr, fs))
    base = None if base_rng is None else torch.from_numpy(base).to(dev)
    sigma = torch.from_numpy(sigma).to(dev)
    before = eb.launches
    out = eb.epiband(fr, fs, base, sigma, D, S_MAX)
    torch.cuda.synchronize()
    assert eb.launches == before + 1
    ref = eb.epiband_reference(fr, fs, base, sigma, D, S_MAX)
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    fr = torch.zeros(1, 2, 128, 8, device=cuda_device)
    fs = torch.zeros(1, 2, 200, 8, device=cuda_device)
    sigma = torch.ones(1, 2, 128)
    with pytest.raises(ValueError, match="one device"):
        eb.epiband(fr, fs, None, sigma, 4, 40)


@pytest.mark.cuda
def test_kernel_rejects_odd_channels(cuda_device):
    fr = torch.zeros(1, 2, 128, 7, device=cuda_device)
    fs = torch.zeros(1, 2, 200, 7, device=cuda_device)
    sigma = torch.ones(1, 2, 128, device=cuda_device)
    with pytest.raises(ValueError, match="even channel count"):
        eb.epiband(fr, fs, None, sigma, 4, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_rejects_misaligned_view(cuda_device, dtype):
    """A contiguous view one element into its storage would fault on the
    kernel's vector loads: the wrapper raises, and the card stays usable."""
    fr = torch.zeros(1, 2, 128, 8, device=cuda_device, dtype=dtype)
    flat = torch.zeros(1 + 2 * 200 * 8, device=cuda_device, dtype=dtype)
    fs = flat[1:].view(1, 2, 200, 8)
    sigma = torch.ones(1, 2, 128, device=cuda_device)
    before = eb.launches
    with pytest.raises(ValueError, match="fs must start on a"):
        eb.epiband(fr, fs, None, sigma, 4, 40)
    out = eb.epiband(fr, fs.contiguous().clone(), None, sigma, 4, 40)
    torch.cuda.synchronize()
    assert eb.launches == before + 1 and float(out.abs().max()) == 0.0


@pytest.mark.cuda
def test_rectified_kernel_route_matches_exact_on_lateral_scene(cuda_device):
    """Lateral baselines: rectification is lossless, so the rectified
    construction through the kernel equals the exact one (fp32, delta
    heads damped so the estimates stay inside the slabs)."""
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.pipeline.inference import InferenceRunner

    model = RAFT(test_mode=True, dtype=torch.float32, device=cuda_device,
                 cascade=((8, 64, 2), (-1, 320, 2)),
                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(2):
            getattr(model.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    H, W, n = 64, 192, 3
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, bx in enumerate([0.0, 1.2, -1.6]):
        poses[i, 0, 3] = -bx
    images = np.random.RandomState(0).rand(n, H, W, 3).astype(np.float32)
    images *= 255
    intr = np.tile(K, (n, 1, 1))
    rect = InferenceRunner(model=model, construction="rectified",
                           rect_lambda_max=0.1, device=cuda_device)
    exact = InferenceRunner(model=model, construction="exact",
                            device=cuda_device)
    before = eb.launches
    a = rect.submit(images, poses, intr, 1.0)[0].cpu().numpy()
    assert rect.last_path == "rectified"
    assert eb.launches == before + 2 * (n - 1)
    b = exact.submit(images, poses, intr, 1.0)[0].cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-7)
