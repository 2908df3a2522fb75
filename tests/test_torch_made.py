"""npe_tpu_torch's MADE / IAF against npe_tpu's: masks bit for bit, the
layers on the same numpy inputs, and the autoregressive property."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from npe_tpu.ops import made as jmade
from npe_tpu_torch.ops import made as tmade

tp.torch_threads()


@pytest.mark.parametrize("n_shuffles", [0, 1, 2])
@pytest.mark.parametrize("seed", [1234, 7])
def test_masks_are_bit_equal_to_npe_tpu(seed, n_shuffles):
    for hidden in ([100], [24, 16]):
        d = hidden[0] if len(hidden) == 1 else 16
        jl, jd = jmade.made_masks(d, hidden, seed=seed, n_shuffles=n_shuffles)
        tl, td = tmade.made_masks(d, hidden, seed=seed, n_shuffles=n_shuffles)
        assert len(tl) == len(jl) == len(hidden) + 1
        for a, b in zip(tl + [td], jl + [jd]):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_masks_follow_an_explicit_ordering_and_sampled_connectivity():
    ordering = np.random.RandomState(3).permutation(16)
    jl, jd = jmade.made_masks(16, [16], ordering=ordering)
    tl, td = tmade.made_masks(16, [16], ordering=ordering)
    for a, b in zip(tl + [td], jl + [jd]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(td.sum(axis=0), ordering)  # column sums are the ordering
    # l > 0 samples hidden connectivity from the generator's stream
    jl, _ = jmade.made_masks(16, [32, 32], seed=5, n_shuffles=1, l=1.0)
    tl, _ = tmade.made_masks(16, [32, 32], seed=5, n_shuffles=1, l=1.0)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)


def _carried(n_hidden_sizes, d=16):
    """npe_tpu's made_init arrays and the same as port tensors."""
    jv = {k: np.asarray(v) for k, v in jmade.made_init(jax.random.PRNGKey(1), "net", d, n_hidden_sizes).items()}
    rng = np.random.RandomState(2)
    for k in jv:  # biases are zeros at init: make them count
        if k.endswith(".b"):
            jv[k] = rng.randn(*jv[k].shape).astype(np.float32)
    return jv, {k: torch.from_numpy(v.copy()) for k, v in jv.items()}


def test_made_init_names_shapes_and_masks():
    jv, _ = _carried([24, 20])
    tv = tmade.made_init(torch.Generator().manual_seed(0), "net", 16, [24, 20], "cpu")
    assert sorted(tv) == sorted(jv)
    for k in jv:
        assert tuple(tv[k].shape) == jv[k].shape and tv[k].dtype == torch.float32, k
        if k.endswith(".weights_mask"):
            np.testing.assert_array_equal(tv[k].numpy(), jv[k])
    assert tmade.mask_names("net", 2) == [
        "net_input.weights_mask", "net_layer_1.weights_mask",
        "net_output_W.weights_mask", "net_output_D.weights_mask",
    ]
    w = tv["net_input.W"]  # orthogonal('relu'): rows orthogonal at gain sqrt(2)
    tp.assert_close((w @ w.T).numpy(), 2.0 * np.eye(16), atol=1e-5)


@pytest.mark.parametrize("hidden", [[16], [24, 20]])
def test_made_apply_and_masked_dense_match_jax(hidden):
    jv, tv = _carried(hidden)
    z = np.random.RandomState(4).randn(5, 16).astype(np.float32)
    want = np.asarray(jmade.made_apply(jv, "net", jnp.asarray(z), n_hidden=len(hidden)))
    got = tmade.made_apply(tv, "net", torch.from_numpy(z), n_hidden=len(hidden))
    assert np.abs(want).max() > 0.5
    tp.assert_close(got.numpy(), want)
    w, m, b = (jv[f"net_input.{s}"] for s in ("W", "weights_mask", "b"))
    want = np.asarray(jmade.masked_dense(jnp.asarray(z), w, m, b, jax.nn.relu))
    got = tmade.masked_dense(torch.from_numpy(z), *(torch.from_numpy(a.copy()) for a in (w, m, b)), torch.relu)
    tp.assert_close(got.numpy(), want)


def test_iaf_transform_matches_jax():
    rng = np.random.RandomState(5)
    z, mu, ls = (rng.randn(4, 16).astype(np.float32) for _ in range(3))
    want = np.asarray(jmade.iaf_transform(jnp.asarray(z), jnp.asarray(mu), jnp.asarray(ls)))
    got = tmade.iaf_transform(*(torch.from_numpy(a) for a in (z, mu, ls)))
    tp.assert_close(got.numpy(), want)


@pytest.mark.parametrize("n_shuffles", [0, 1])
def test_made_is_autoregressive(n_shuffles):
    """Output j depends only on inputs ordered strictly before it."""
    d = 12
    tv = tmade.made_init(torch.Generator().manual_seed(3), "net", d, [d], "cpu", n_shuffles=n_shuffles)
    ordering = tv["net_output_D.weights_mask"].numpy().sum(axis=0).astype(int)
    assert sorted(ordering) == list(range(d))
    z = torch.randn(d, generator=torch.Generator().manual_seed(4))
    jac = torch.autograd.functional.jacobian(lambda z: tmade.made_apply(tv, "net", z[None])[0], z)
    jac = jac.numpy()  # [output j, input i]
    for j in range(d):
        for i in range(d):
            if ordering[i] >= ordering[j]:
                assert jac[j, i] == 0.0, (j, i)
    assert (np.abs(jac) > 0).sum() > d  # and it does depend on the earlier ones
