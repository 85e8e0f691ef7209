"""The port's CUDA kernels (R, B, T) against their plain PyTorch versions.

The kernel tests need an NVIDIA GPU: they carry the ``cuda`` marker and skip
without one. Where JAX (which ``tests/conftest.py`` imports) is not
installed, run them with ``python -m pytest --noconftest
tests/test_torch_cuda.py -q``; ``chip_smoke.py`` runs the same comparisons
at the frontend's shapes. The
last test runs anywhere: a tensor that is neither on the CPU nor on a CUDA
device is refused, never sent down the plain path."""

import numpy as np
import pytest
import torch

import chip_smoke
from airslam_tpu_torch.ops import bilerp, remap
from airslam_tpu_torch.ops.gridsample import remap as remap_plain

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_remap_kernel_equals_plain_on_euroc_grids(dev):
    """Compiled with -fmad=false: bit-equal to the plain version."""
    rng = np.random.RandomState(0)
    grids = torch.as_tensor(chip_smoke.euroc_grids(), device=dev)
    imgs = torch.as_tensor(rng.rand(2, 480, 752).astype(np.float32), device=dev)
    before = remap.remap.launches
    got = remap.remap(imgs, grids)
    assert remap.remap.launches == before + 1
    for i in range(2):
        torch.testing.assert_close(got[i], remap_plain(imgs[i], grids[i]), rtol=0, atol=0)
    one = remap.remap(imgs[0], grids[0])  # the single-image form
    torch.testing.assert_close(one, got[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        remap.remap(imgs.transpose(1, 2), grids)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,shape", [(128, (300,)), (4, (512, 30)), (7, (13,))])
def test_bilerp_kernels_equal_plain(dev, dtype, c, shape):
    """B and T vs the plain version: 1e-5 abs for f32, 1e-5 of the map's max
    for bf16 (same rounded weights; FMA contraction only)."""
    rng = np.random.RandomState(c)
    fmap = torch.as_tensor(rng.randn(128, 128, c).astype(np.float32), device=dev).to(dtype)
    x = torch.as_tensor(rng.uniform(-1.5, 129.5, shape).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.uniform(-1.5, 129.5, shape).astype(np.float32), device=dev)
    x.view(-1)[:4] = torch.tensor([127.0, 127.5, -0.5, 0.0])
    want = bilerp.bilerp_plain(fmap, x, y)
    tol = 1e-5 * (1.0 if dtype == torch.float32 else float(fmap.float().abs().max()))
    torch.testing.assert_close(bilerp.bilerp_points(fmap, x, y), want, rtol=0, atol=tol)
    torch.testing.assert_close(bilerp.bilerp_points_t(fmap, x, y),
                               torch.movedim(want, -1, 0), rtol=0, atol=tol)
    with pytest.raises(ValueError):
        bilerp.bilerp_points(fmap.transpose(0, 1), x, y)


def test_wrappers_refuse_non_cuda_devices():
    """Only a CPU tensor takes the plain version; anything else must be a
    CUDA tensor or the wrapper raises."""
    fmap = torch.empty((8, 8, 4), device="meta")
    pts = torch.empty((5,), device="meta")
    for fn in (bilerp.bilerp_points, bilerp.bilerp_points_t):
        with pytest.raises(ValueError, match="CUDA"):
            fn(fmap, pts, pts)
    with pytest.raises(ValueError, match="CUDA"):
        remap.remap(torch.empty((8, 8), device="meta"), torch.empty((8, 8, 2), device="meta"))
