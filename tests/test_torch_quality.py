"""The port's encoder-FID (`npe_tpu_torch/training/quality.py`) against
npe_tpu's (`training/quality.py`): the Frechet algebra to 1e-9 on the same
statistics, the encoder features within the golden tolerance on the same
weights and images (tiny IAN_simple, running BN statistics moved off the
identity), and the cases of `tests/test_quality.py`, at the tiny profiles."""

import json

import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.models import get_config as jax_config
from npe_tpu.training import quality as JQ
from npe_tpu_torch.data import SyntheticFaces
from npe_tpu_torch.models import get_config
from npe_tpu_torch.training import quality as Q
from npe_tpu_torch.utils import checkpoints as tckpt
from npe_tpu_torch.utils.ranges import to_tanh

tp.torch_threads()


def _real(n, seed=0):
    return to_tanh(np.float32(SyntheticFaces(num_examples=n, seed=seed).get_data(np.arange(n))))


@pytest.mark.parametrize("seed, shift, eps", [(0, 0.0, 1e-6), (1, 2.0, 1e-6), (2, 0.3, 0.0)])
def test_frechet_distance_and_stats_equal_npe_tpu(seed, shift, eps):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(200, 8)
    f2 = rng.randn(150, 8) * 1.5 + shift
    for a, b in ((Q.feature_stats(f1), JQ.feature_stats(f1)), (Q.feature_stats(f2), JQ.feature_stats(f2))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    got = Q.frechet_distance(*Q.feature_stats(f1), *Q.feature_stats(f2), eps=eps)
    want = JQ.frechet_distance(*JQ.feature_stats(f1), *JQ.feature_stats(f2), eps=eps)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_frechet_identity_is_zero():
    mu, cov = Q.feature_stats(np.random.RandomState(0).randn(200, 8))
    assert Q.frechet_distance(mu, cov, mu, cov) < 1e-6


def test_frechet_diagonal_gaussians_analytic():
    mu1, mu2 = np.array([0.0, 1.0, -2.0]), np.array([1.0, 1.0, 0.0])
    a, b = np.array([1.0, 4.0, 0.25]), np.array([9.0, 1.0, 1.0])
    expect = np.sum((mu1 - mu2) ** 2) + np.sum((np.sqrt(a) - np.sqrt(b)) ** 2)
    np.testing.assert_allclose(Q.frechet_distance(mu1, np.diag(a), mu2, np.diag(b), eps=0.0), expect, rtol=1e-6)


def test_frechet_symmetric_and_shift_sensitive():
    f1 = np.random.RandomState(1).randn(300, 6)
    s1, s2 = Q.feature_stats(f1), Q.feature_stats(f1 + 2.0)
    d12, d21 = Q.frechet_distance(*s1, *s2), Q.frechet_distance(*s2, *s1)
    np.testing.assert_allclose(d12, d21, rtol=1e-6)
    assert d12 > 10.0  # ~ |shift|^2 * dim = 24


@pytest.mark.parametrize("batch_size", [4, 3])
def test_batched_features_match_npe_tpu(batch_size):
    """(N, 128) at tiny width ((N, 1024) at full width), float64, trailing
    images that fill no batch dropped by both."""
    v = tp.with_bn_state(tp.jax_variables(tp.TINY_JAX), seed=3)
    real = _real(10)
    want = JQ.batched_features(jax_config(tp.TINY_JAX), tp.as_jax(v), real.transpose(0, 2, 3, 1), batch_size)
    got = Q.batched_features(get_config(tp.TINY_TORCH), tckpt.from_reference(v, "cpu"), real, batch_size)
    assert got.dtype == np.float64 and got.shape == want.shape == (10 // batch_size * batch_size, 128)
    tp.assert_close(got, want)
    assert got.std() > 1e-3


def test_batched_features_take_tensors_and_refuse_less_than_a_batch():
    tm = get_config(tp.TINY_TORCH)
    v = tm.init(torch.Generator().manual_seed(0), "cpu")
    real = _real(4)
    np.testing.assert_array_equal(Q.batched_features(tm, v, torch.from_numpy(real), 2),
                                  Q.batched_features(tm, v, real, 2))
    with pytest.raises(ValueError, match="no batch"):
        Q.batched_features(tm, v, real[:3], 4)


@pytest.mark.parametrize("model", ["IAN_simple", "IAN"])
def test_model_samples_decode_seeded_latents_pre_iaf(model):
    config = {"IAN_simple": tp.TINY_TORCH, "IAN": tp.TINY_FULL_TORCH}[model]
    tm = get_config(config)
    v = tm.init(torch.Generator().manual_seed(0), "cpu")
    got = Q.model_samples(tm, v, 5, batch_size=2, seed=4)
    assert got.shape == (5, 3, 64, 64) and got.dtype == torch.float32
    z = torch.randn((6, tm.cfg["num_latents"]), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want = torch.cat([tm.decode_pre_iaf(v, z[i : i + 2]) for i in range(0, 6, 2)])[:5]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(Q.model_samples(tm, v, 5, batch_size=2, seed=4), got)


def test_encoder_fid_frozen_feature_space():
    """With `feature_variables` fixed, the metric is invariant to changes in
    the *sampled* model's encoder (incl. BN state) -- only its decoder output
    matters -- and sensitive to decoder changes (tests/test_quality.py)."""
    tm = get_config(tp.TINY_TORCH)
    ref, cur = (tckpt.from_reference(tckpt.unit_gain(tckpt.to_reference(tm.init(torch.Generator().manual_seed(s),
                                                                                  "cpu"))), "cpu") for s in (0, 1))
    real = _real(16)
    base = Q.encoder_fid(tm, cur, real, num=16, batch_size=16, feature_variables=ref)
    assert np.isfinite(base) and base > 0

    enc = {k: v + 0.5 for k, v in cur.items()
           if k.startswith(("enc_conv", "bnorm2.", "bnorm3.", "bnorm4.")) and not k.endswith(".weights_mask")}
    assert enc
    same = Q.encoder_fid(tm, {**cur, **enc}, real, num=16, batch_size=16, feature_variables=ref)
    np.testing.assert_allclose(same, base, rtol=1e-6)

    dec = {k: v * 1.5 for k, v in cur.items() if k.startswith("dec_conv")}
    moved = Q.encoder_fid(tm, {**cur, **dec}, real, num=16, batch_size=16, feature_variables=ref)
    assert abs(moved - base) > 1e-3


def test_quality_cli_prints_one_json_line(tmp_path, capsys):
    tm = get_config(tp.TINY_TORCH)
    weights = tmp_path / "w.npz"
    tckpt.save_weights(str(weights), tm.init(torch.Generator().manual_seed(2), "cpu"))
    Q.main([tp.TINY_TORCH, "--weights", str(weights), "--num", "8", "--batch-size", "4", "--device", "cpu"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(line)
    assert rec["metric"] == "encoder_fid" and rec["num"] == 8 and np.isfinite(rec["value"]) and rec["value"] > 0
