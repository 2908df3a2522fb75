"""The edit_tail wrapper and its plain version against npe_tpu's Pallas
kernel (interpret mode) and its reference, on the CPU. The CUDA kernel
itself is held to the plain version on the GPU by `chip_smoke.py` and by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as tp
from npe_tpu.ops.pallas import editor_kernels as jk
from npe_tpu_torch.ops.kernels import edit_tail as tk

tp.torch_threads()


def _inputs(seed, batch=None, user_mask="random"):
    rng = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    xh = rng.rand(*lead, 64, 64, 3).astype(np.float32) * 2 - 1
    recon = rng.rand(*lead, 64, 64, 3).astype(np.float32) * 2 - 1
    err = rng.rand(*lead, 64, 64, 3).astype(np.float32) * 0.2
    um = {
        None: None,
        "random": rng.rand(*lead, 64, 64).astype(np.float32) * 0.5,
        "ones": np.ones((*lead, 64, 64), np.float32),
    }[user_mask]
    return xh, recon, err, um


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("sigma", [0.7, 1.5])
def test_blur_matrix_equals_jax(sigma):
    # The same float32 accumulation over the same folded indices: exact.
    np.testing.assert_array_equal(
        tk.blur_matrix(64, sigma).numpy(), np.asarray(jk.blur_matrix(64, sigma))
    )


@pytest.mark.parametrize("sigma", [0.7, 1.5])
@pytest.mark.parametrize("user_mask", [None, "random", "ones"])
def test_plain_matches_pallas_interpret_and_reference(user_mask, sigma):
    xh, recon, err, um = _inputs(1, user_mask=user_mask)
    got = tk.edit_tail(_t(xh), _t(recon), _t(err), _t(um), sigma).numpy()
    args = [jnp.asarray(a) for a in (xh, recon, err)]
    jum = None if um is None else jnp.asarray(um)
    pallas = np.asarray(jk.edit_tail(*args, jum, sigma, interpret=True))
    ref = np.asarray(jk.edit_tail_reference(*args, jk.blur_matrix(64, sigma), jum))
    tp.assert_close(got, pallas)
    tp.assert_close(got, ref)
    if user_mask == "ones":  # a saturated floor shows the decode itself
        tp.assert_close(got, xh)


def test_batch_equals_each_image():
    xh, recon, err, um = _inputs(2, batch=3)
    out = tk.edit_tail(_t(xh), _t(recon), _t(err), _t(um))
    for i in range(3):
        one = tk.edit_tail(_t(xh[i]), _t(recon[i]), _t(err[i]), _t(um[i]))
        np.testing.assert_allclose(out[i].numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_leave_the_launch_counter_unchanged():
    before = tk.edit_tail.launches
    xh, recon, err, um = _inputs(3)
    tk.edit_tail(_t(xh), _t(recon), _t(err), _t(um))
    assert tk.edit_tail.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xh, recon, err, um = (_t(a) for a in _inputs(4))
    with pytest.raises(ValueError, match="contiguous"):
        tk.edit_tail(xh.transpose(0, 1), recon, err, um)
    with pytest.raises(TypeError, match="float32"):
        tk.edit_tail(xh.double(), recon.double(), err.double(), um.double())
    with pytest.raises(ValueError, match="images"):
        tk.edit_tail(xh[:, :32], recon[:, :32], err[:, :32])
    with pytest.raises(ValueError, match="user_mask"):
        tk.edit_tail(xh, recon, err, um[:32])
    with pytest.raises(ValueError, match="multiple of 4"):  # rows are read as float4
        odd = torch.zeros(62, 62, 3)
        tk.edit_tail(odd, odd, odd)
    with pytest.raises(ValueError, match="shared memory"):  # not even a band of one row fits
        big = torch.zeros(512, 512, 3)
        tk.edit_tail(big, big, big, sigma=3.0)
    big = torch.zeros(128, 128, 3)  # the one-block-per-image kernel refused this; a band takes it
    assert tk.edit_tail(big, big, big).shape == (128, 128, 3)


@pytest.mark.parametrize("sigma", [0.7, 1.5, 3.0])
def test_band_rows_fill_one_wave_and_fit_shared_memory(sigma):
    """The kernel's bands: one row each at batch 1 (64 blocks), wider as the
    batch grows, always a divisor of n whose block fits the 48 KB check, and
    all blocks in one wave on 132 multiprocessors while they can be."""
    _, radius = tk.gaussian_kernel_1d(sigma)
    assert radius == {0.7: 3, 1.5: 6, 3.0: 12}[sigma]
    assert tk.band_rows(1, 64, radius, 132) == 1
    assert [tk.band_rows(b, 64, radius, 132) for b in (2, 3, 8, 16, 128, 1000)] == [1, 2, 4, 8, 64, 64]
    for batch in (1, 2, 5, 8, 33, 128, 1000):
        rows = tk.band_rows(batch, 64, radius, 132)
        assert 64 % rows == 0
        assert tk.edit_tail_smem_bytes(64, rows, radius) <= tk.SMEM_LIMIT
        assert batch * 64 // rows <= 132 or rows == 64


def test_shared_memory_size_is_what_the_check_refuses():
    """edit_tail_smem_bytes is the kernel's layout, and `_check` refuses
    exactly the sizes at which not even a band of one row fits."""
    assert tk.edit_tail_smem_bytes(64, 1, 3) == ((1 + 6) * 64 + 64 + 7) * 4
    assert tk.edit_tail_smem_bytes(64, 64, 12) == ((64 + 24) * 64 + 64 * 64 + 25) * 4 < tk.SMEM_LIMIT
    _, radius = tk.gaussian_kernel_1d(3.0)
    fits = [n for n in range(4, 1025, 4) if tk.edit_tail_smem_bytes(n, 1, radius) <= tk.SMEM_LIMIT]
    largest = fits[-1]
    assert tk.band_rows(1, largest, radius, 132) is not None
    assert tk.band_rows(1, largest + 4, radius, 132) is None
    for n, refused in ((largest, False), (largest + 4, True)):
        img = torch.zeros(n, n, 3)
        if refused:
            with pytest.raises(ValueError, match="shared memory"):
                tk.edit_tail(img, img, img, sigma=3.0)
        else:
            assert tk.edit_tail(img, img, img, sigma=3.0).shape == (n, n, 3)


def _edit_tail_by_bands(xh, recon, error, user_mask, sigma, rows):
    """The kernel's cut of an image, in PyTorch: for each band of `rows`
    rows, m over the band and the radius either side (rows folded by
    reflect), blurred along H into the band, then along W over whole rows."""
    k, radius = tk.gaussian_kernel_1d(sigma)
    k = torch.from_numpy(k)
    n = xh.shape[0]
    m = torch.clamp((xh - recon).abs().mean(-1), max=1.0)
    cols = torch.tensor([[tk.reflect_index(j + t, n) for t in range(-radius, radius + 1)] for j in range(n)])
    out = []
    for y0 in range(0, n, rows):
        src = [tk.reflect_index(y0 - radius + q, n) for q in range(rows + 2 * radius)]
        band_m = m[src]
        hb = torch.stack([(k[:, None] * band_m[i:i + 2 * radius + 1]).sum(0) for i in range(rows)])
        mask = (hb[:, cols] * k).sum(-1)
        if user_mask is not None:
            mask = torch.clamp(mask + user_mask[y0:y0 + rows], 0.0, 1.0)
        mask = mask[..., None]
        r, d = recon[y0:y0 + rows], xh[y0:y0 + rows] - recon[y0:y0 + rows]
        out.append(r + mask * d + (1.0 - mask) * error[y0:y0 + rows])
    return torch.cat(out)


@pytest.mark.parametrize("sigma,rows,n", [(0.7, 1, 64), (1.5, 4, 64), (3.0, 1, 64), (3.0, 2, 8), (1.5, 8, 8)])
def test_bands_with_a_reflected_halo_compute_the_whole_tail(sigma, rows, n):
    """m on a band's rows and the radius either side, folded by reflect even
    where the radius exceeds the band or the image (radius 12 at n = 8), is
    all a band needs: the bands put together are the plain version."""
    xh, recon, err, um = (None if a is None else _t(a[:n, :n]) for a in _inputs(6))
    want = tk.edit_tail(xh.contiguous(), recon.contiguous(), err.contiguous(), um.contiguous(), sigma)
    got = _edit_tail_by_bands(xh, recon, err, um, sigma, rows)
    tp.assert_close(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
