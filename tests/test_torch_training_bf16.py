"""Mixed-precision training (cfg['compute_dtype'] = 'bfloat16') of
npe_tpu_torch against its own float32 training and against npe_tpu's bf16
training, at the tiny profiles, batch 4, on the CPU.

The same variables (npe_tpu's init at unit gain), batch, z_rand and
reparameterization noise go through all three runs: npe_tpu draws its noise
from the step's key in bf16 (`ops/sampling.py`), and the port is given those
same values. The tolerances are npe_tpu's own for its bf16 trajectories
(`tests/test_training.py`): rtol 0.12 / atol 0.02 over three G/D pairs of
IAN_simple, 0.15 / 0.03 over one pair of full IAN, on (G pixel loss, G kl,
D discrim loss) after each pair.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.models import get_config as jax_config
from npe_tpu.training import train_step as JTS
from npe_tpu_torch.models import common, get_config
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt
from npe_tpu_torch.training import graph as TG
from npe_tpu_torch.training import losses as TL
from npe_tpu_torch.training import train_step as TTS
from npe_tpu_torch.utils import checkpoints as tckpt

tp.torch_threads()

CONFIGS = {"IAN_simple": (tp.TINY_JAX, tp.TINY_TORCH), "IAN": (tp.TINY_FULL_JAX, tp.TINY_FULL_TORCH)}
# (pairs, rtol, atol): npe_tpu's bounds, tests/test_training.py:99-140 and :224-254
TRAJECTORY = {"IAN_simple": (3, 0.12, 0.02), "IAN": (1, 0.15, 0.03)}
LR = 2e-4
BF16 = {"compute_dtype": "bfloat16"}


def _keys(pairs):
    """The (G, D) keys of each pair, as npe_tpu's bf16 trajectory test draws them."""
    return [(k, jax.random.fold_in(k, 1)) for k in (jax.random.PRNGKey(100 + i) for i in range(pairs))]


def _trajectory_row(mg, md):
    return (float(mg["pixel_loss"]), float(mg["kl"]), float(md["discrim_d_loss"]))


@functools.cache
def jax_run(model):
    """npe_tpu's bf16 trajectory, its initial state and the bf16 noise each
    step drew (numpy)."""
    jm = jax_config(CONFIGS[model][0])
    cfg = dict(jm.cfg, **BF16)
    x, z, _, _ = tp.training_batch(cfg)
    state = JTS.init_train_state(jm, tp.as_jax(tp.jax_variables(CONFIGS[model][0])), cfg)
    state0 = jax.tree_util.tree_map(np.asarray, state)
    gen_step, discrim_step = JTS.make_train_steps(jm, cfg, donate=False)
    traj, noise = [], []
    for kg, kd in _keys(TRAJECTORY[model][0]):
        state, mg = gen_step(state, x, z, kg, LR)
        state, md = discrim_step(state, x, z, kd, LR)
        traj.append(_trajectory_row(mg, md))
        # what sample_latent drew: normal(key, mu.shape, mu.dtype), mu bf16
        noise.append([np.asarray(jax.random.normal(k, z.shape, jnp.bfloat16)).astype(np.float32) for k in (kg, kd)])
    return (x, z), state0, np.asarray(traj), noise


@functools.cache
def port_run(model, compute_dtype):
    """The port's trajectory from npe_tpu's initial state on the same batch
    and noise: (initial state, final state, trajectory)."""
    (x, z), state0_np, _, noise = jax_run(model)
    tm = get_config(CONFIGS[model][1])
    cfg = dict(tm.cfg, compute_dtype=compute_dtype)
    state0 = tckpt.train_state_from_reference(state0_np, "cpu")
    gen_step, discrim_step = TTS.make_train_steps(tm, cfg)
    xt, zt = tp.nchw(x), torch.from_numpy(z)
    state, traj = state0, []
    for eg, ed in noise:
        state, mg = gen_step(state, xt, zt, torch.from_numpy(eg), LR)
        state, md = discrim_step(state, xt, zt, torch.from_numpy(ed), LR)
        traj.append(_trajectory_row(mg, md))
    return state0, state, np.asarray(traj)


@pytest.mark.parametrize("model", list(CONFIGS))
def test_bf16_trajectory_tracks_the_port_float32_one(model):
    _, rtol, atol = TRAJECTORY[model]
    _, _, bf16 = port_run(model, "bfloat16")
    _, _, f32 = port_run(model, None)
    assert np.all(np.isfinite(bf16))
    np.testing.assert_allclose(bf16, f32, rtol=rtol, atol=atol)
    assert not np.array_equal(bf16, f32)  # the bf16 run did run in bf16


@pytest.mark.parametrize("model", list(CONFIGS))
def test_bf16_trajectory_tracks_npe_tpu_bf16_one(model):
    _, rtol, atol = TRAJECTORY[model]
    _, _, want, _ = jax_run(model)
    _, _, got = port_run(model, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("model", list(CONFIGS))
def test_bf16_training_keeps_masters_moments_and_bn_state_float32(model):
    state0, state, _ = port_run(model, "bfloat16")
    pairs = TRAJECTORY[model][0]
    for part in ("gen", "latent", "discrim", "frozen"):
        assert all(t.dtype == torch.float32 for t in state["parts"][part].values()), part
    for part in ("gen", "latent", "discrim"):
        opt = state["opt"][part]
        assert all(t.dtype == torch.float32 for m in ("mu", "nu") for t in opt[m].values()), part
        assert opt["count"].dtype == torch.int32
    assert int(state["opt"]["latent"]["count"]) == 2 * pairs and int(state["step"]) == 2 * pairs
    bn = [k for k in state["parts"]["state"] if k.endswith((".mean", ".inv_std"))]
    assert bn and all(state["parts"]["state"][k].dtype == torch.float32 for k in bn)
    assert any(not torch.equal(state["parts"]["state"][k], state0["parts"]["state"][k]) for k in bn)
    # the frozen flow and the masks are not touched, bit for bit
    for k, t in state["parts"]["frozen"].items():
        assert torch.equal(t, state0["parts"]["frozen"][k]), k
    for k, t in state["parts"]["state"].items():
        if k.endswith(".weights_mask"):
            assert t.dtype == torch.float32 and torch.equal(t, state0["parts"]["state"][k]), k


def test_bf16_gradients_reach_the_float32_masters_and_the_cut_keeps_bf16():
    """The forward runs on bf16 casts of the float32 leaves; its gradients
    come back through the casts as float32. The D step's cut hand-off is a
    bf16 leaf, and the gradient carried across it is bf16."""
    tm = get_config(tp.TINY_TORCH)
    cfg = dict(tm.cfg, **BF16)
    parts = TL.partition_variables(tp.port_variables(tp.TINY_JAX))
    x, z, _, eps = tp.training_batch(cfg)
    batch = tp.nchw(x), torch.from_numpy(z), torch.from_numpy(eps)
    g_gen, g_lat, out, upd = TTS.gen_grads(tm, cfg, parts, *batch)
    assert all(g.dtype == torch.float32 for d in (g_gen, g_lat) for g in d.values())
    assert all(v.dtype == torch.float32 and not v.requires_grad for v in upd.values())
    assert out["x_hat"].dtype == out["mu"].dtype == torch.float32  # widened for the losses
    d, lat = TTS._leaves(parts["discrim"]), TTS._leaves(parts["latent"])
    other = {**parts["gen"], **parts["frozen"], **parts["state"]}
    _, zloss, (out, _) = TG.discrim_and_latent_losses(d, lat, other, tm, cfg, *batch)
    x_hat_in, x_hat = out["cut"]
    assert x_hat_in.dtype == x_hat.dtype == torch.bfloat16 and x_hat_in.is_leaf
    (g_cut,) = torch.autograd.grad(zloss, [x_hat_in], retain_graph=True)
    assert g_cut.dtype == torch.bfloat16
    g_d, g_z, _, _ = TTS.discrim_grads(tm, cfg, parts, *batch)
    assert all(g.dtype == torch.float32 for dd in (g_d, g_z) for g in dd.values())


@pytest.mark.parametrize("bad", ["float16", "int8", torch.float16, "bf16"])
def test_an_unknown_compute_dtype_raises(bad):
    tm = get_config(tp.TINY_TORCH)
    cfg = dict(tm.cfg, compute_dtype=bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TTS.make_train_steps(tm, cfg)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TTS.init_train_state(tm, tp.port_variables(tp.TINY_JAX), cfg)


@pytest.mark.parametrize("spelling", [None, "float32", "bfloat16", torch.bfloat16, torch.float32])
def test_to_compute_casts_the_trainable_variables_and_the_batch(spelling):
    variables = tp.port_variables(tp.TINY_FULL_JAX)
    x, z = torch.zeros(2, 3, 64, 64), torch.zeros(2, 16)
    cast, xc, zc = TG.to_compute(variables, x, z, {"compute_dtype": spelling})
    want = torch.bfloat16 if spelling in ("bfloat16", torch.bfloat16) else torch.float32
    assert xc.dtype == zc.dtype == want
    for k, v in cast.items():
        assert v.dtype == (want if common.is_trainable(k) else torch.float32), k
    if want == torch.float32:
        assert all(cast[k] is v for k, v in variables.items()) and xc is x


def test_the_noise_takes_mu_dtype():
    from npe_tpu_torch.ops.sampling import gaussian_sample

    mu, ls = torch.zeros(2, 4, dtype=torch.bfloat16), torch.zeros(2, 4, dtype=torch.bfloat16)
    eps = torch.tensor([[0.1, -1.3, 2.0, 0.5]] * 2)
    z = gaussian_sample(mu, ls, eps)
    assert z.dtype == torch.bfloat16 and torch.equal(z, eps.to(torch.bfloat16))
    assert gaussian_sample(mu, ls, torch.Generator().manual_seed(0)).dtype == torch.bfloat16


def test_the_tail_plain_version_gives_bf16_gradients_for_bf16_inputs():
    """The kernel's backward is its plain version's VJP (`vjp_of_plain`):
    bf16 inputs get bf16 gradients, close to the float32 VJP's."""
    rng = np.random.RandomState(4)
    trunk = torch.from_numpy(rng.randn(2, 96, 4, 4).astype(np.float32))
    tg = torch.from_numpy(rng.randn(9, 32, 32).astype(np.float32) * 0.1)
    tb = torch.from_numpy(rng.randn(9, 64, 32).astype(np.float32) * 0.1)
    g = torch.from_numpy(rng.randn(2, 48, 4, 4).astype(np.float32))
    got = rt.vjp_of_plain(rt.rgb_beta_tail_reference, (True, True, True),
                          [t.to(torch.bfloat16) for t in (trunk, tg, tb)], g.to(torch.bfloat16))
    want = rt.vjp_of_plain(rt.rgb_beta_tail_reference, (True, True, True), [trunk, tg, tb], g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=0.05, atol=0.05 * float(b.abs().max()))


@pytest.mark.parametrize("what", ["float32 taps", "float16", "non-contiguous trunk"])
def test_the_tail_bf16_form_raises_on_what_it_cannot_take(what):
    """No cast around the kernel: a mixed or unsupported dtype, or a layout
    the kernel cannot read, raises before anything runs, on any device."""
    trunk = torch.zeros(1, 96, 4, 4, dtype=torch.bfloat16)
    tg, tb = torch.zeros(9, 32, 32, dtype=torch.bfloat16), torch.zeros(9, 64, 32, dtype=torch.bfloat16)
    if what == "float32 taps":
        tg, tb = tg.float(), tb.float()
    elif what == "float16":
        trunk, tg, tb = (t.half() for t in (trunk, tg, tb))
    else:
        trunk = torch.zeros(1, 4, 4, 96, dtype=torch.bfloat16).permute(0, 3, 1, 2)
    with pytest.raises((TypeError, ValueError)):
        rt.rgb_beta_tail(trunk, tg, tb)


def test_a_bf16_step_runs_the_tail_in_bf16_and_the_mdblocks_per_op(monkeypatch):
    """Full IAN, one G and one D step under bf16: each decode (the
    reconstruction and the sample, two a step) calls the tail once, with bf16
    trunk and taps, so 4 a G + D pair; the fused MDBLOCK and the fused head
    are never called under training."""
    calls = []

    def tail(trunk, tg, tb):
        calls.append((trunk.dtype, tg.dtype, tb.dtype))
        return rt.rgb_beta_tail(trunk, tg, tb)

    def refuse(*args, **kwargs):
        raise AssertionError("a fused kernel form was called under training")

    monkeypatch.setattr(common, "rgb_beta_tail", tail)
    monkeypatch.setattr(common, "mdblock_fused", refuse)
    monkeypatch.setattr(common, "rgb_beta_head_kernel", refuse)
    tm = get_config(tp.TINY_FULL_TORCH)
    cfg = dict(tm.cfg, **BF16)
    state = TTS.init_train_state(tm, tp.port_variables(tp.TINY_FULL_JAX), cfg)
    x, z, _, eps = tp.training_batch(cfg)
    gen_step, discrim_step = TTS.make_train_steps(tm, cfg)
    batch = tp.nchw(x), torch.from_numpy(z), torch.from_numpy(eps)
    state, _ = gen_step(state, *batch, LR)
    discrim_step(state, *batch, LR)
    assert calls == [(torch.bfloat16,) * 3] * 4
