"""npe_tpu_torch's training slice against npe_tpu's on the tiny profiles, batch
4, CPU: the same variables (npe_tpu's init at unit gain), batch, z_rand and
reparameterization noise go through both.

Tolerances, and why (`tests/torch_parity.py`, "training parity"):
  * forward, losses, metrics, BN statistics, float32: rtol 1e-3 / atol 1e-4,
    the golden tolerance; they are continuous in the inputs;
  * gradients, Adam moments and whole steps, float64 in both packages:
    rtol 1e-5 and 1e-6 of each tensor's largest value; the float32 gradients
    jump by about 1 % whenever one relu of 6e5 rounds to the other side;
  * Adam alone on identical gradients: 1e-6;
  * whole float32 steps: parameters within 8 * lr, as npe_tpu's own chunk
    test allows (Adam's first steps are sign-like: a parameter whose gradient
    is rounding noise moves by +-lr).
"""

import contextlib
import functools
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from npe_tpu.models import get_config as jax_config
from npe_tpu.training import graph as JG
from npe_tpu.training import losses as JL
from npe_tpu.training import train as JT
from npe_tpu.training import train_step as JTS
from npe_tpu_torch.models import get_config
from npe_tpu_torch.training import graph as TG
from npe_tpu_torch.training import losses as TL
from npe_tpu_torch.training import train as TT
from npe_tpu_torch.training import train_step as TTS
from npe_tpu_torch.utils import checkpoints as tckpt

tp.torch_threads()

CONFIGS = {
    "IAN_simple": (tp.TINY_JAX, tp.TINY_TORCH),
    "IANv1": (tp.TINY_V1_JAX, tp.TINY_V1_TORCH),
    "IAN": (tp.TINY_FULL_JAX, tp.TINY_FULL_TORCH),
}
MODELS = list(CONFIGS)
LR = 2e-4
LOSS_FNS = ("gen_loss_fn", "discrim_loss_fn", "latent_loss_fn")
# the partitions each loss function differentiates, and the rest
WRT = {"gen_loss_fn": ("gen", "latent"), "discrim_loss_fn": ("discrim",), "latent_loss_fn": ("latent",)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _split(parts, wrt):
    params = {k: v for p in wrt for k, v in parts[p].items()}
    other = {k: v for p in parts if p not in wrt for k, v in parts[p].items()}
    return params, other


def _variables(model, dtype):
    return {k: np.asarray(v, dtype) for k, v in tp.jax_variables(CONFIGS[model][0]).items()}


def _torch_batch(x, z, eps):
    return tp.nchw(x), torch.from_numpy(z), torch.from_numpy(eps)


# --- npe_tpu's side, one jitted program per model and kind -------------------


@functools.cache
def jax_forward(model):
    """float32: forward_all's outputs, the metrics and the three losses."""
    jm = jax_config(CONFIGS[model][0])
    cfg = dict(jm.cfg)
    x, z, key, eps = tp.training_batch(cfg)
    parts = JL.partition_variables(tp.as_jax(_variables(model, np.float32)))

    @jax.jit
    def run(parts):
        v = JL.merge_partitions(parts)
        upd = {}
        out = JG.forward_all(jm, v, x, z, key, upd=upd)
        metrics = JG.compute_metrics(cfg, out, x, jm.N_DISCRIM_CLASSES)
        losses = {name: getattr(JG, name)(*_split(parts, WRT[name]), jm, cfg, x, z, key)[0] for name in LOSS_FNS}
        return out, upd, metrics, losses

    return (x, z, eps), _np_tree(run(parts))


@functools.cache
def jax_loss_grads(model):
    """float64: each loss function's value and gradient."""
    jm = jax_config(CONFIGS[model][0])
    cfg = dict(jm.cfg)
    with tp.x64():
        x, z, key, eps = tp.training_batch(cfg, dtype=np.float64)
        parts = JL.partition_variables(tp.as_jax(_variables(model, np.float64)))

        @jax.jit
        def run(parts):
            out = {}
            for name in LOSS_FNS:
                (loss, _), grads = jax.value_and_grad(getattr(JG, name), has_aux=True)(
                    *_split(parts, WRT[name]), jm, cfg, x, z, key)
                out[name] = (loss, grads)
            return out

        return (x, z, eps), _np_tree(run(parts))


@functools.cache
def jax_steps(model, dtype_name):
    """One G step and one D step from the same initial state."""
    dtype = np.dtype(dtype_name).type
    jm = jax_config(CONFIGS[model][0])
    cfg = dict(jm.cfg)
    with tp.x64() if dtype is np.float64 else contextlib.nullcontext():
        x, z, key, eps = tp.training_batch(cfg, dtype=dtype)
        state0 = JTS.init_train_state(jm, tp.as_jax(_variables(model, dtype)), cfg)
        gen_step, discrim_step = JTS.make_train_steps(jm, cfg, donate=False)
        after = {"gen": gen_step(state0, x, z, key, LR), "discrim": discrim_step(state0, x, z, key, LR)}
        return (x, z, eps), _np_tree(state0), _np_tree(after)


# --- partitions and losses ----------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_partition_of_every_variable(model):
    names = list(tp.jax_variables(CONFIGS[model][0]))
    assert {k: TL.partition_of(k) for k in names} == {k: JL.partition_of(k) for k in names}
    parts = TL.partition_variables(tp.port_variables(CONFIGS[model][0]))
    assert list(parts) == list(TL.PARTITIONS)
    assert bool(parts["frozen"]) == (model != "IAN_simple")
    assert all(parts[p] for p in ("gen", "latent", "discrim", "state"))
    assert list(TL.merge_partitions(parts)) == [k for p in parts.values() for k in p]
    assert sorted(TL.merge_partitions(parts)) == sorted(names)


def _loss_case(name):
    rng = np.random.RandomState(5)
    a, b = (rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32) for _ in range(2))
    mu, ls = (rng.randn(4, 16).astype(np.float32) * 0.5 for _ in range(2))
    logits3, logits1 = rng.randn(4, 3).astype(np.float32), rng.randn(4, 1).astype(np.float32)
    feats = [rng.randn(4, s, s, c).astype(np.float32) for s, c in ((8, 4), (4, 8))]
    feats2 = [f + 0.1 * rng.randn(*f.shape).astype(np.float32) for f in feats]
    t = torch.from_numpy
    return {
        "pixel_l1": ((a, b), (tp.nchw(a), tp.nchw(b))),
        "pixel_mse": ((a, b), (tp.nchw(a), tp.nchw(b))),
        "gaussian_nll_pixel": ((a, b, 0.3 * a), (tp.nchw(a), tp.nchw(b), tp.nchw(0.3 * a))),
        "kl_to_standard_normal": ((mu, ls), (t(mu), t(ls))),
        "feature_matching": ((feats, feats2), ([tp.nchw(f) for f in feats], [tp.nchw(f) for f in feats2])),
        "softmax_ce": ((logits3, 1), (t(logits3), 1)),
        "sigmoid_bce": ((logits1, 1.0), (t(logits1), 1.0)),
    }[name]


@pytest.mark.parametrize("name", ["pixel_l1", "pixel_mse", "gaussian_nll_pixel", "kl_to_standard_normal",
                                  "feature_matching", "softmax_ce", "sigmoid_bce"])
def test_loss_matches_jax(name):
    jargs, targs = _loss_case(name)
    tp.assert_close(getattr(TL, name)(*targs).numpy(), getattr(JL, name)(*jargs), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_classes", [1, 3])
def test_adversarial_losses_match_jax(n_classes):
    rng = np.random.RandomState(6)
    logits = [rng.randn(8, n_classes).astype(np.float32) for _ in range(3)]
    want = JL.adversarial_losses(*logits, n_classes)
    got = TL.adversarial_losses(*(torch.from_numpy(p) for p in logits), n_classes)
    assert list(got) == list(want)
    for k in want:
        tp.assert_close(got[k].numpy(), want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["enc_conv2.W", "dec_conv2.W", "dec_conv2aW"])
def test_ortho_penalty_per_tensor_matches_jax(name):
    """A conv kernel, a deconv kernel and an MDCL filter: the port's
    contraction differs per kind, and a wrong axis would give a finite,
    wrong penalty."""
    v = tp.jax_variables(tp.TINY_FULL_JAX)
    assert v[name].shape[2] != v[name].shape[3] or name == "dec_conv2aW"  # cin != cout tells the axes apart
    port = tckpt.from_reference({name: v[name]}, "cpu")
    want = float(JL.ortho_penalty({name: jnp.asarray(v[name])}))
    assert want > 1.0
    tp.assert_close(float(TL.ortho_penalty(port)), want, rtol=1e-5, atol=1e-6)
    tp.assert_close(float(TL.ortho_res(port[name], deconv=tckpt.is_deconv(name))), want, rtol=1e-5, atol=1e-6)
    if v[name].shape[2] != v[name].shape[3]:  # the other kind's contraction is another number
        assert abs(float(TL.ortho_res(port[name], deconv=not tckpt.is_deconv(name))) - want) > 1e-3 * want


def test_ortho_and_l2_penalties_over_a_whole_model_match_jax():
    v = tp.jax_variables(tp.TINY_FULL_JAX)
    port = tp.port_variables(tp.TINY_FULL_JAX)
    tp.assert_close(float(TL.ortho_penalty(port)), float(JL.ortho_penalty(tp.as_jax(v))), rtol=1e-5)
    tp.assert_close(float(TL.l2_penalty(port)), float(JL.l2_penalty(tp.as_jax(v))), rtol=1e-5)
    assert float(TL.l2_penalty({"a.b": torch.ones(3), "bnorm.gamma": torch.ones(3)})) == 0.0


# --- forward, losses and metrics, float32 -------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_forward_all_losses_and_metrics_match_jax(model):
    (x, z, eps), (jout, jupd, jmetrics, jlosses) = jax_forward(model)
    tm = get_config(CONFIGS[model][1])
    cfg = dict(tm.cfg)
    parts = TL.partition_variables(tp.port_variables(CONFIGS[model][0]))
    xt, zt, et = _torch_batch(x, z, eps)
    upd = {}
    with torch.no_grad():
        out = TG.forward_all(tm, TL.merge_partitions(parts), xt, zt, et, upd=upd)
        metrics = TG.compute_metrics(cfg, out, xt, tm.N_DISCRIM_CLASSES)
        losses = {name: getattr(TG, name)(*_split(parts, WRT[name]), tm, cfg, xt, zt, et)[0] for name in LOSS_FNS}
    for k in ("mu", "ls", "p_x", "p_x_hat", "p_x_gen"):
        tp.assert_close(out[k].numpy(), jout[k])
    tp.assert_close(tp.nhwc(out["x_hat"]), jout["x_hat"])
    for name in ("g_x", "g_xh"):
        for a, b in zip(out[name], jout[name]):
            tp.assert_close(tp.nhwc(a), b)
    # only the real-X pass and the reconstruction decode write running stats
    assert sorted(upd) == sorted(jupd)
    for k in jupd:
        tp.assert_close(upd[k].numpy(), jupd[k])
        assert not upd[k].requires_grad
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        tp.assert_close(float(metrics[k]), jmetrics[k])
    for name in LOSS_FNS:
        tp.assert_close(float(losses[name]), jlosses[name])


def test_loss_functions_detach_the_bn_updates_and_refuse_compute_dtype():
    """The BN updates leave the loss functions detached; cfg['compute_dtype']
    takes float32 and bfloat16 (float32 losses and BN updates either way) and
    refuses any other dtype with a ValueError."""
    tm = get_config(tp.TINY_TORCH)
    cfg = dict(tm.cfg)
    parts = TL.partition_variables(tp.port_variables(tp.TINY_JAX))
    x, z, _, eps = tp.training_batch(cfg)
    params, other = _split(parts, ("gen", "latent"))
    _, (_, upd) = TG.gen_loss_fn(TTS._leaves(params), other, tm, cfg, *_torch_batch(x, z, eps))
    assert upd and not any(t.requires_grad for t in upd.values())
    for fn in (TG.gen_loss_fn, TG.discrim_loss_fn, TG.latent_loss_fn):
        for accepted in ("float32", "bfloat16", torch.bfloat16, None):
            loss, (_, upd) = fn(params, other, tm, dict(cfg, compute_dtype=accepted), *_torch_batch(x, z, eps))
            assert loss.dtype == torch.float32 and all(t.dtype == torch.float32 for t in upd.values())
            assert not any(t.requires_grad for t in upd.values())
        with pytest.raises(ValueError, match="compute_dtype"):
            fn(params, other, tm, dict(cfg, compute_dtype="float16"), *_torch_batch(x, z, eps))
    with pytest.raises(ValueError, match="compute_dtype"):
        TTS.init_train_state(tm, TL.merge_partitions(parts), dict(cfg, compute_dtype="float16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        TTS.make_train_steps(tm, dict(cfg, compute_dtype="int8"))
    TTS.make_train_steps(tm, dict(cfg, compute_dtype="bfloat16"))


# --- gradients, float64 --------------------------------------------------------


@pytest.mark.parametrize("name", LOSS_FNS)
@pytest.mark.parametrize("model", MODELS)
def test_loss_value_and_partition_gradients_match_jax_in_float64(model, name):
    (x, z, eps), ref = jax_loss_grads(model)
    want_loss, want_grads = ref[name]
    tm = tp.plain_head(get_config(CONFIGS[model][1]))
    parts = TL.partition_variables(tckpt.from_reference(_variables(model, np.float64), "cpu"))
    params, other = _split(parts, WRT[name])
    leaves = TTS._leaves(params)
    loss, _ = getattr(TG, name)(leaves, other, tm, dict(tm.cfg), *_torch_batch(x, z, eps))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
    grads = tckpt.to_reference(TTS._grad(loss, leaves))
    assert grads["enc_fc1.W" if "latent" in WRT[name] else "enc_conv1.W"].dtype == np.float64
    tp.assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("model", MODELS)
def test_d_step_gradients_equal_the_two_gradient_form(model):
    """`discrim_grads` takes both partitions' gradients from one forward
    with pass 2 on a cut copy of x_hat; they must be the gradient of
    `discrim_loss_fn` w.r.t. the discrim partition and of `latent_loss_fn`
    w.r.t. the latent partition, taken separately (npe_tpu's
    test_fused_d_step_grads_match_two_grad_form). float32, the default head:
    both forms run the same forward, so no rounding separates their kinks."""
    tm = get_config(CONFIGS[model][1])
    cfg = dict(tm.cfg)
    parts = TL.partition_variables(tp.port_variables(CONFIGS[model][0]))
    x, z, _, eps = tp.training_batch(cfg, seed=1)
    batch = _torch_batch(x, z, eps)
    g_d, g_z, out, upd = TTS.discrim_grads(tm, cfg, parts, *batch)
    assert sorted(g_d) == sorted(parts["discrim"]) and sorted(g_z) == sorted(parts["latent"])
    for wrt, fn, got in ((("discrim",), TG.discrim_loss_fn, g_d), (("latent",), TG.latent_loss_fn, g_z)):
        params, other = _split(parts, wrt)
        leaves = TTS._leaves(params)
        loss, _ = fn(leaves, other, tm, cfg, *batch)
        want = TTS._grad(loss, leaves)
        assert max(float(w.abs().max()) for w in want.values()) > 1e-3
        tp.assert_grads_close({k: g.numpy() for k, g in got.items()}, {k: w.numpy() for k, w in want.items()},
                              rtol=1e-4, atol_of_largest=1e-5)
    # what reusing a live pass 2 for dloss would add is not small: the leak
    # through x_hat -> decoder -> z -> latent heads -> enc_fc1 <- conv tower
    d, lat = TTS._leaves(parts["discrim"]), TTS._leaves(parts["latent"])
    other = {**parts["gen"], **parts["frozen"], **parts["state"]}
    live = TG.forward_all(tm, {**other, **d, **lat}, *batch)
    adv = TL.adversarial_losses(live["p_x"], live["p_x_hat"], live["p_x_gen"], tm.N_DISCRIM_CLASSES)
    leaky = TTS._grad(TG._discrim_objective(cfg, adv, d), d)
    assert float((leaky["enc_conv4.W"] - g_d["enc_conv4.W"]).abs().max()) > 1e-3 * float(g_d["enc_conv4.W"].abs().max())


# --- Adam ----------------------------------------------------------------------


@pytest.mark.parametrize("moments_dtype", [None, "bfloat16"])
def test_adam_matches_optax_over_three_steps(moments_dtype):
    rng = np.random.RandomState(8)
    shapes = {"a.W": (5, 5, 4, 6), "b.W": (7, 3), "c.beta": (9,)}
    p_np = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-4, 1)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lr, b1 = 1e-2, 0.5
    opt = JTS.make_optimizer(b1, moments_dtype)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jstate = opt.init(jp)
    md = getattr(torch, moments_dtype) if moments_dtype else None
    tparams = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    tstate = TTS.init_opt_state(tparams, md)
    for step, g in enumerate(grads, start=1):
        jp, jstate = JTS._apply(opt, {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp, lr)
        before = {k: v.clone() for k, v in tparams.items()}
        new_p, tstate = TTS.adam_update(tparams, {k: torch.from_numpy(v) for k, v in g.items()}, tstate, lr, b1,
                                        moments_dtype=md)
        for k in before:  # out of place: the state it was given is untouched
            assert torch.equal(tparams[k], before[k]) and new_p[k].data_ptr() != tparams[k].data_ptr()
        tparams = new_p
        assert int(tstate["count"]) == int(jstate.count) == step
        for k in shapes:
            # 1e-6 on a step of lr * O(1): the update itself to 1e-4
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)
            for moment, jm_ in (("mu", jstate.mu), ("nu", jstate.nu)):
                got = tstate[moment][k]
                assert got.dtype == (md or torch.float32)
                want = np.asarray(jm_[k]).astype(np.float32)
                # bfloat16: the float32 values agree to 1e-6 and may round to
                # neighbouring bfloat16 values, 2**-8 apart
                np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7 if md else 1e-6,
                                           atol=1e-12, err_msg=f"{moment}/{k}")


def test_init_train_state_mirrors_npe_tpu():
    jm, tm = jax_config(tp.TINY_FULL_JAX), get_config(tp.TINY_FULL_TORCH)
    jstate = JTS.init_train_state(jm, tp.as_jax(tp.jax_variables(tp.TINY_FULL_JAX)), dict(jm.cfg))
    tstate = TTS.init_train_state(tm, tp.port_variables(tp.TINY_FULL_JAX), dict(tm.cfg))
    assert {p: sorted(d) for p, d in tstate["parts"].items()} == {p: sorted(d) for p, d in jstate["parts"].items()}
    assert sorted(tstate["opt"]) == sorted(jstate["opt"]) == ["discrim", "gen", "latent"]
    for p, o in tstate["opt"].items():
        assert int(o["count"]) == 0 and o["count"].dtype == torch.int32
        assert sorted(o["mu"]) == sorted(o["nu"]) == sorted(tstate["parts"][p])
        assert all(not t.any() and t.shape == tstate["parts"][p][k].shape for k, t in o["mu"].items())
    assert int(tstate["step"]) == 0
    bf = TTS.init_train_state(tm, tp.port_variables(tp.TINY_FULL_JAX), dict(tm.cfg, moments_dtype="bfloat16"))
    assert all(t.dtype == torch.bfloat16 for o in bf["opt"].values() for t in o["nu"].values())
    with pytest.raises(ValueError, match="moments_dtype"):
        TTS.init_train_state(tm, tp.port_variables(tp.TINY_FULL_JAX), dict(tm.cfg, moments_dtype="int8"))


# --- whole steps ---------------------------------------------------------------


def _port_steps(model, dtype_name, x, z, eps, state0_np):
    tm = get_config(CONFIGS[model][1])
    if dtype_name == "float64":
        tm = tp.plain_head(tm)
    state0 = tckpt.train_state_from_reference(state0_np, "cpu")
    gen_step, discrim_step = TTS.make_train_steps(tm, dict(tm.cfg))
    batch = _torch_batch(x, z, eps)
    return state0, {"gen": gen_step(state0, *batch, LR), "discrim": discrim_step(state0, *batch, LR)}


def _moved(a, b):
    return sum(float((a[k].double() - b[k].double()).abs().sum()) for k in a)


@pytest.mark.parametrize("player", ["gen", "discrim"])
@pytest.mark.parametrize("model", MODELS)
def test_step_matches_jax_in_float64(model, player):
    """Parameters, moments (so the step's gradients: after the first step
    mu = (1 - b1) * g), counts, BN state and metrics; frozen weights and
    masks bit-equal; the other player's partition untouched."""
    (x, z, eps), state0_np, after = jax_steps(model, "float64")
    want_state, want_metrics = after[player]
    state0, got_after = _port_steps(model, "float64", x, z, eps, state0_np)
    new, metrics = got_after[player]
    got = tckpt.train_state_to_reference(new)
    other = "discrim" if player == "gen" else "gen"
    for part in (player, "latent"):
        want_opt = want_state["opt"][part]
        assert int(got["opt"][part]["count"]) == int(want_opt.count) == 1
        tp.assert_grads_close(got["opt"][part]["mu"], want_opt.mu)
        tp.assert_grads_close(got["opt"][part]["nu"], want_opt.nu, atol_of_largest=1e-6, floor=1e-16)
        for k, want in want_state["parts"][part].items():
            assert got["parts"][part][k].dtype == np.float64
            # the first step is lr * g / (|g| + 1e-8): where |g| > 1e-4 the
            # two agree as the gradients do; a gradient near zero, which the
            # two sides round differently, may move its parameter by lr
            err = np.abs(got["parts"][part][k] - want)
            sure = np.abs(2 * np.asarray(want_opt.mu[k])) > 1e-4
            assert err.max() <= 1.01 * LR and (not sure.any() or err[sure].max() <= 1e-9), (k, err.max())
        assert _moved(new["parts"][part], state0["parts"][part]) > 0
    assert int(got["opt"][other]["count"]) == 0
    assert int(got["step"]) == int(want_state["step"]) == 1
    for k, want in want_state["parts"]["state"].items():
        # npe_tpu's loss functions hand the new statistics back as float32
        np.testing.assert_allclose(got["parts"]["state"][k], want, rtol=2e-7, atol=1e-7, err_msg=k)
    assert sorted(metrics) == sorted(want_metrics)
    for k, want in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-5, atol=1e-6, err_msg=k)
    # partition isolation, bit for bit
    for part in (other, "frozen"):
        for k, t in new["parts"][part].items():
            assert torch.equal(t, state0["parts"][part][k]), k
    for k, t in new["parts"]["state"].items():
        if k.endswith(".weights_mask"):
            assert torch.equal(t, state0["parts"]["state"][k]), k
    stats = ["bnorm2.mean", "bnorm_dc3.inv_std" if model == "IAN_simple" else "bnorm_dc4.mean"]
    stats += ["dec_conv2abnorm1.inv_std"] if model == "IAN" else []
    for k in stats:
        assert not torch.equal(new["parts"]["state"][k], state0["parts"]["state"][k]), k


@pytest.mark.parametrize("player", ["gen", "discrim"])
@pytest.mark.parametrize("model", ["IAN_simple", "IAN"])
def test_step_matches_jax_in_float32_with_the_default_head(model, player):
    """The step as the trainer runs it: float32, the hybrid RGB-Beta head.
    Metrics and BN state at the golden tolerance; parameters within 8 * lr
    (sign-like first Adam steps); the gradients (2 * mu) within 10 % of each
    tensor's largest value, which a few relus rounding to the other side in
    either package account for, and a missing loss term would not."""
    (x, z, eps), state0_np, after = jax_steps(model, "float32")
    want_state, want_metrics = after[player]
    state0, got_after = _port_steps(model, "float32", x, z, eps, state0_np)
    new, metrics = got_after[player]
    got = tckpt.train_state_to_reference(new)
    for part in (player, "latent"):
        tp.assert_grads_close(got["opt"][part]["mu"], want_state["opt"][part].mu, rtol=0, atol_of_largest=1e-1,
                              floor=1e-6)
        for k, want in want_state["parts"][part].items():
            assert got["parts"][part][k].dtype == np.float32
            np.testing.assert_allclose(got["parts"][part][k], want, rtol=0, atol=8 * LR, err_msg=k)
    for k, want in want_state["parts"]["state"].items():
        tp.assert_close(got["parts"]["state"][k], want)
    for k, want in want_metrics.items():
        tp.assert_close(float(metrics[k]), want)
    for k, t in new["parts"]["frozen"].items():
        assert torch.equal(t, state0["parts"]["frozen"][k]), k


def test_skip_nonfinite_updates_drops_the_whole_step():
    tm = get_config(tp.TINY_FULL_TORCH)
    cfg = dict(tm.cfg, skip_nonfinite_updates=True)
    variables = tp.port_variables(tp.TINY_FULL_JAX)
    x, z, _, eps = tp.training_batch(cfg)
    xt, zt, et = _torch_batch(x, z, eps)
    state0 = TTS.init_train_state(tm, variables, cfg)
    guarded = TTS.make_train_steps(tm, cfg)
    plain = TTS.make_train_steps(tm, dict(tm.cfg))
    for g_step, p_step in zip(guarded, plain):
        new, m = g_step(state0, xt, zt, et, LR)
        ref, m_ref = p_step(state0, xt, zt, et, LR)
        assert float(m["update_skipped"]) == 0.0 and "update_skipped" not in m_ref
        for (_, (_, a)), (_, (_, b)) in zip(tckpt._flat_train_state(new).items(), tckpt._flat_train_state(ref).items()):
            assert torch.equal(a, b)
        bad = xt.clone()
        bad[0, 0, 0, 0] = float("inf")
        new, m = g_step(state0, bad, zt, et, LR)
        assert isinstance(m["update_skipped"], torch.Tensor) and float(m["update_skipped"]) == 1.0
        for path, (_, a) in tckpt._flat_train_state(new).items():
            if path != "step":
                assert torch.equal(a, tckpt._flat_train_state(state0)[path][1]), path
        assert int(new["step"]) == 1
        poisoned, _ = p_step(state0, bad, zt, et, LR)
        assert not all(torch.isfinite(t).all() for t in poisoned["parts"]["latent"].values())


# --- the adaptive-ratio guard ----------------------------------------------------


@pytest.mark.parametrize("threshold", [0.8, 0.6])
def test_guard_functions_match_the_host_oracle_of_both_packages(threshold):
    """`guard_schedule` / `guard_ema_update` on tensors reproduce the port's
    AdaptiveRatioGuard and npe_tpu's, decision for decision and EMA for EMA,
    over 300 steps whose D accuracies saturate and recover (npe_tpu's
    test_on_device_guard_matches_host_oracle)."""
    period = 2
    rs = np.random.RandomState(11)
    d_acc = np.where((np.arange(300) // 40) % 2 == 0, rs.uniform(0.95, 1.0, 300),
                     rs.uniform(0.45, 0.55, 300)).astype(np.float32)
    host, jax_host = TT.AdaptiveRatioGuard(threshold, period), JT.AdaptiveRatioGuard(threshold, period)
    ema = torch.tensor(TTS.GUARD_CHANCE, dtype=torch.float32)
    skipped = 0
    for itr in range(300):
        is_gen, skip_d = TTS.guard_schedule(itr % period == 0, ema, threshold)
        host_gen = host.should_gen(itr)
        assert bool(is_gen) == host_gen == jax_host.should_gen(itr), itr
        assert bool(skip_d) == (host_gen and itr % period != 0)
        skipped += bool(skip_d)
        ema = TTS.guard_ema_update(ema, is_gen, skip_d, torch.tensor(d_acc[itr]))
        if not host_gen:
            host.observe(d_acc[itr])
            jax_host.observe(d_acc[itr])
        np.testing.assert_allclose(float(ema), host.ema, rtol=0, atol=1e-5)
        assert host.ema == jax_host.ema
    assert 10 < skipped < 150
    assert (TTS.GUARD_DECAY, TTS.GUARD_CHANCE) == (JTS.GUARD_DECAY, JTS.GUARD_CHANCE)


def _chunk_setup(nb=4, bs=4, **overrides):
    tm = get_config(tp.TINY_TORCH)
    cfg = dict(tm.cfg, batch_size=bs, **overrides)
    rng = np.random.RandomState(7)
    x_chunk = torch.from_numpy(rng.uniform(-0.8, 0.8, (nb * bs, 3, 64, 64)).astype(np.float32))
    state0 = TTS.init_train_state(tm, tp.port_variables(tp.TINY_JAX), cfg)
    return tm, cfg, x_chunk, state0


def _assert_states_equal(a, b):
    fa, fb = tckpt._flat_train_state(a), tckpt._flat_train_state(b)
    assert list(fa) == list(fb)
    for path in fa:
        assert torch.equal(fa[path][1], fb[path][1]), path


def test_chunk_loop_matches_the_per_step_loop():
    """Same generator, same draws (z_rand, then the noise, per batch), same
    G/D alternation from itr0: the chunk loop's state is the per-step
    loop's bit for bit and its metrics are the per-player means."""
    nb, bs = 4, 4
    tm, cfg, x_chunk, state0 = _chunk_setup(nb, bs)
    gen_step, discrim_step = TTS.make_train_steps(tm, cfg)
    for itr0 in (0, 1):
        gen = torch.Generator().manual_seed(21)
        state, rows = state0, []
        for i in range(nb):
            z_rand = torch.randn((bs, cfg["num_latents"]), generator=gen)
            noise = torch.randn((bs, cfg["num_latents"]), generator=gen)
            step = gen_step if (itr0 + i) % 2 == 0 else discrim_step
            state, m = step(state, x_chunk[i * bs : (i + 1) * bs], z_rand, noise, LR)
            rows.append({k: float(v) for k, v in m.items()})
        gen2 = torch.Generator().manual_seed(21)
        state2, gen_m, dis_m, n_gen = TTS.make_chunk_step(tm, cfg, nb)(state0, x_chunk, itr0, gen2, LR)
        assert n_gen == 2 and isinstance(n_gen, int)
        assert torch.equal(gen.get_state(), gen2.get_state())
        _assert_states_equal(state2, state)
        assert int(state2["step"]) == nb
        assert int(state2["opt"]["latent"]["count"]) == nb and int(state2["opt"]["gen"]["count"]) == 2
        g_rows = [r for i, r in enumerate(rows) if (itr0 + i) % 2 == 0]
        d_rows = [r for i, r in enumerate(rows) if (itr0 + i) % 2 == 1]
        for k in gen_m:
            np.testing.assert_allclose(float(gen_m[k]), np.mean([r[k] for r in g_rows]), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(float(dis_m[k]), np.mean([r[k] for r in d_rows]), rtol=1e-5, atol=1e-6)


def test_guarded_chunk_is_faithful_when_the_threshold_is_unreachable():
    nb = 4
    tm, cfg, x_chunk, state0 = _chunk_setup(nb)
    ref, _, _, n_ref = TTS.make_chunk_step(tm, cfg, nb)(state0, x_chunk, 0, torch.Generator().manual_seed(21), LR)
    ema0 = torch.tensor(TTS.GUARD_CHANCE)
    got, _, _, n_gen, ema = TTS.make_chunk_step(tm, cfg, nb, guard_acc=1.1)(
        state0, x_chunk, 0, torch.Generator().manual_seed(21), LR, ema0)
    assert n_gen == n_ref == 2
    _assert_states_equal(got, ref)
    assert 0.0 <= float(ema) <= 1.0
    # a 2-step chunk runs one D step, whose accuracy IS dis_m: one oracle update
    _, _, dis_m, _, ema2 = TTS.make_chunk_step(tm, cfg, 2, guard_acc=1.1)(
        state0, x_chunk[:8], 0, torch.Generator().manual_seed(21), LR, ema0)
    want = TTS.GUARD_DECAY * TTS.GUARD_CHANCE + (1 - TTS.GUARD_DECAY) * float(dis_m["discrim_acc"])
    np.testing.assert_allclose(float(ema2), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="EMA"):
        TTS.make_chunk_step(tm, cfg, 2, guard_acc=1.1)(state0, x_chunk[:8], 0, torch.Generator(), LR)


def test_guarded_chunk_skips_every_d_step_when_the_threshold_is_zero():
    nb = 4
    tm, cfg, x_chunk, state0 = _chunk_setup(nb)
    state, _, _, n_gen, ema = TTS.make_chunk_step(tm, cfg, nb, guard_acc=0.0)(
        state0, x_chunk, 0, torch.Generator().manual_seed(21), LR, torch.tensor(TTS.GUARD_CHANCE))
    assert n_gen == nb
    np.testing.assert_allclose(float(ema), TTS.GUARD_CHANCE, rtol=0, atol=1e-7)
    assert _moved(state["parts"]["discrim"], state0["parts"]["discrim"]) == 0  # D never ran
    assert _moved(state["parts"]["gen"], state0["parts"]["gen"]) > 0


# --- the trainer -------------------------------------------------------------------


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_train_defaults_to_the_card_and_refuses_what_is_not_ported(tmp_path, capsys, monkeypatch):
    import inspect

    assert inspect.signature(TT.train).parameters["device"].default == "cuda"
    assert inspect.signature(tckpt.load_train_state).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.train(tp.TINY_TORCH, out_dir=str(tmp_path))
        assert not list(tmp_path.iterdir())  # it raised before it wrote anything
    with pytest.raises(FileNotFoundError):
        TT.train(tp.TINY_TORCH, "native:" + str(tmp_path / "nowhere.raw"), out_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        TT.train(tp.TINY_TORCH, out_dir=str(tmp_path), device="cpu", cfg_overrides={"compute_dtype": "float16"})
    if not torch.cuda.is_available():  # --data-parallel alone: a world of one, on the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.main([tp.TINY_TORCH, "--data-parallel"])
    # every flag of npe_tpu's trainer reaches train(), --data-parallel as a mesh
    seen = {}
    monkeypatch.setattr(TT, "train", lambda **kw: seen.update(kw))
    TT.main([tp.TINY_TORCH, "--compute-dtype=bfloat16", "--profile-dir=trace", "--fid-feature-weights=basis.npz",
             "--dataset=native:train.raw", "--valid-dataset=synthetic", "--data-parallel", "--device=cpu"])
    assert seen["cfg_overrides"] == {"compute_dtype": "bfloat16"} and seen["dataset_spec"] == "native:train.raw"
    assert seen["mesh"].shape == (1, 1) and seen["mesh"].device == torch.device("cpu")
    assert (seen["profile_dir"], seen["fid_feature_weights"]) == ("trace", "basis.npz")


@pytest.mark.parametrize("device_cache_bytes", [2 << 30, 0], ids=["device-cache", "per-chunk-upload"])
def test_train_two_tiny_epochs_then_resume(tmp_path, device_cache_bytes):
    from npe_tpu_torch.ops.kernels.staging import stage_chunk

    kw = dict(config=tp.TINY_FULL_TORCH, dataset_spec="synthetic", num_examples=24, out_dir=str(tmp_path),
              pics_dir=str(tmp_path / "pics"), checkpoint_grids=False, device="cpu",
              device_cache_bytes=device_cache_bytes, cfg_overrides={"batch_size": 4, "batches_per_chunk": 2})
    state = TT.train(max_epochs=2, **kw)
    assert stage_chunk.launches == 0  # CPU tensors never reach the kernel
    weights, state_file = tmp_path / "tiny_ian_full.npz", tmp_path / "tiny_ian_full_train_state.npz"
    recs = _records(tmp_path / "tiny_ian_fullMETRICS.jsonl")
    # 24 examples, chunks of 8: 3 chunks at offset 0, 2 at the half-batch offset
    assert [r["itr"] for r in recs] == [2, 4, 6, 8, 10] and [r["epoch"] for r in recs] == [0, 0, 0, 1, 1]
    for r in recs:
        assert set(r["metrics"]) == set(TT.GEN_KEYS + TT.DISCRIM_KEYS)
        assert all(np.isfinite(v) for v in r["metrics"].values())
    meta = tckpt.train_state_metadata(str(state_file))
    assert (meta["epoch"], meta["itr"], meta["format_version"]) == (1, 10, 1) and meta["learning_rate"] == 2e-4
    assert "leaf_dtypes" not in meta
    loaded = tckpt.load_train_state(str(state_file), "cpu")
    _assert_states_equal(loaded, state)
    assert int(loaded["step"]) == 10 and int(loaded["opt"]["latent"]["count"]) == 10
    masks0 = {k: v.clone() for k, v in state["parts"]["state"].items() if k.endswith(".weights_mask")}
    frozen0 = {k: v.clone() for k, v in state["parts"]["frozen"].items()}
    assert len(masks0) == 6 and frozen0

    resumed = TT.train(max_epochs=3, resume=True, **kw)
    recs = _records(tmp_path / "tiny_ian_fullMETRICS.jsonl")
    assert [r["itr"] for r in recs] == [2, 4, 6, 8, 10, 12, 14, 16] and recs[-1]["epoch"] == 2
    assert tckpt.train_state_metadata(str(state_file))["epoch"] == 2
    assert int(resumed["step"]) == 16
    for k, v in masks0.items():  # the masks and the frozen flow survive training and the resume
        assert torch.equal(resumed["parts"]["state"][k], v), k
    for k, v in frozen0.items():
        assert torch.equal(resumed["parts"]["frozen"][k], v), k
    assert _moved(resumed["parts"]["gen"], state["parts"]["gen"]) > 0

    # the weights file is npe_tpu's ABI: it loads into npe_tpu, masks and all
    from npe_tpu.utils import checkpoints as jckpt

    jm = jax_config(tp.TINY_FULL_JAX)
    jv = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(9)).items()}
    jmeta = jckpt.load_weights(str(weights), jv)
    assert (jmeta["epoch"], jmeta["itr"]) == (2, 16) and sorted(jmeta["made_orderings"]) == ["l_IAF_ls", "l_IAF_mu"]
    want = tckpt.to_reference(TTS.variables_of(resumed))
    assert sorted(jv) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(jv[k]), want[k], err_msg=k)


def test_train_with_the_guard_validation_and_grids(tmp_path):
    """The adaptive path, bf16 moments, the validation pass and the grid
    picture run end to end on the tiny profile."""
    TT.train(tp.TINY_TORCH, "synthetic", max_epochs=1, num_examples=16, out_dir=str(tmp_path),
             pics_dir=str(tmp_path / "pics"), device="cpu", valid_dataset_spec="synthetic", num_valid_examples=16,
             async_checkpoint=True,
             cfg_overrides={"adaptive_ratio_acc": 0.8, "batch_size": 4, "batches_per_chunk": 2,
                            "moments_dtype": "bfloat16", "skip_nonfinite_updates": True})
    recs = _records(tmp_path / "tiny_ianMETRICS.jsonl")
    chunks = [r for r in recs if "metrics" in r]
    assert len(chunks) == 2 and all("d_steps_skipped" in r["metrics"] for r in chunks)
    valid = [r for r in recs if "validation" in r]
    assert len(valid) == 1 and 0.0 < valid[0]["validation"]["test_error"] <= 1.0
    assert (tmp_path / "pics" / "tiny_ian_0.png").stat().st_size > 1000
    state = tckpt.load_train_state(str(tmp_path / "tiny_ian_train_state.npz"), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in state["opt"]["gen"]["mu"].values())


def test_train_from_a_native_raw_file_in_bf16_with_fid_and_a_trace(tmp_path):
    """Every hook of the trainer at once: a `native:` raw file written by
    `export_raw`, bf16 compute, a validation set with encoder-FID and a
    profiler trace; then a resumed epoch reads the FID basis back."""
    from npe_tpu_torch.data import SyntheticFaces, data_loader
    from npe_tpu_torch.data.native_loader import export_raw
    from npe_tpu_torch.training.quality import encoder_fid

    raw = tmp_path / "train.raw"
    assert export_raw(SyntheticFaces(num_examples=20), str(raw)) == (20, (3, 64, 64))
    trace_dir = tmp_path / "trace"
    kw = dict(config=tp.TINY_TORCH, dataset_spec=f"native:{raw}", out_dir=str(tmp_path),
              pics_dir=str(tmp_path / "pics"), checkpoint_grids=False, device="cpu", valid_dataset_spec="synthetic",
              num_valid_examples=12, cfg_overrides={"batch_size": 4, "batches_per_chunk": 2,
                                                    "compute_dtype": "bfloat16"})
    state = TT.train(max_epochs=1, profile_dir=str(trace_dir), **kw)
    recs = _records(tmp_path / "tiny_ianMETRICS.jsonl")
    # 20 records, chunks of 8: two chunks at offset 0
    assert [r["itr"] for r in recs if "metrics" in r] == [2, 4]
    assert all(np.isfinite(v) for r in recs if "metrics" in r for v in r["metrics"].values())
    (valid,) = [r["validation"] for r in recs if "validation" in r]
    assert np.isfinite(valid["encoder_fid"]) and valid["encoder_fid"] > 0
    assert all(t.dtype == torch.float32 for t in TTS.variables_of(state).values() if t.is_floating_point())
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    basis = tmp_path / "tiny_ian_fid_basis.npz"
    assert tckpt.load_weights(str(basis), {})["epoch"] == 0
    basis_bytes = basis.read_bytes()

    TT.train(max_epochs=2, resume=True, **kw)
    assert basis.read_bytes() == basis_bytes  # read back, not taken anew
    valid = [r for r in _records(tmp_path / "tiny_ianMETRICS.jsonl") if "validation" in r]
    assert [r["epoch"] for r in valid] == [0, 1]
    # epoch 1's FID is the final weights' against epoch 0's basis: recompute it
    tm = get_config(tp.TINY_TORCH)
    final, frozen = (tm.init(torch.Generator().manual_seed(0), "cpu") for _ in range(2))
    tckpt.load_weights(str(tmp_path / "tiny_ian.npz"), final)
    tckpt.load_weights(str(basis), frozen)
    real = next(iter(data_loader(dict(tm.cfg, batch_size=4, batches_per_chunk=3), SyntheticFaces(12), offset=0)))
    want = encoder_fid(tm, final, real, num=12, seed=1, feature_variables=frozen)
    np.testing.assert_allclose(valid[1]["validation"]["encoder_fid"], want, rtol=1e-6)
    assert abs(encoder_fid(tm, final, real, num=12, seed=1) - want) > 1e-6  # another basis, another value


def test_train_fid_feature_weights_fix_the_basis(tmp_path):
    """--fid-feature-weights: the basis is that file's, none is saved, and
    a validation set smaller than a batch still gives one FID chunk."""
    from npe_tpu_torch.data import SyntheticFaces
    from npe_tpu_torch.training.quality import encoder_fid
    from npe_tpu_torch.utils.ranges import to_tanh

    tm = get_config(tp.TINY_TORCH)
    fixed = tm.init(torch.Generator().manual_seed(5), "cpu")
    tckpt.save_weights(str(tmp_path / "fixed.npz"), fixed)
    TT.train(tp.TINY_TORCH, "synthetic", max_epochs=1, num_examples=16, out_dir=str(tmp_path),
             checkpoint_grids=False, device="cpu", valid_dataset_spec="synthetic", num_valid_examples=3,
             fid_feature_weights=str(tmp_path / "fixed.npz"), cfg_overrides={"batch_size": 4, "batches_per_chunk": 2})
    (valid,) = [r["validation"] for r in _records(tmp_path / "tiny_ianMETRICS.jsonl") if "validation" in r]
    assert np.isfinite(valid["encoder_fid"])
    assert not (tmp_path / "tiny_ian_fid_basis.npz").exists()
    final = tm.init(torch.Generator().manual_seed(0), "cpu")
    tckpt.load_weights(str(tmp_path / "tiny_ian.npz"), final)
    real = to_tanh(np.float32(SyntheticFaces(3).get_data(np.arange(3))))
    want = encoder_fid(tm, final, real, num=3, seed=0, feature_variables=fixed)
    np.testing.assert_allclose(valid["encoder_fid"], want, rtol=1e-6)


def test_sample_cli_writes_its_grid(tmp_path, monkeypatch, capsys):
    from npe_tpu_torch.training import sample
    from npe_tpu_torch.utils.png import decode_rgb

    config = os.path.abspath(tp.TINY_FULL_TORCH)
    monkeypatch.chdir(tmp_path)
    tm = get_config(config)
    tckpt.save_weights("weights.npz", tm.init(torch.Generator().manual_seed(3), "cpu"))
    out = sample.main([config, "--epoch", "7", "--weights", "weights.npz", "--device", "cpu"])
    assert out == "pics/tiny_ian_full_sample7.png" and "wrote pics/tiny_ian_full_sample7.png" in capsys.readouterr().out
    grid = decode_rgb((tmp_path / out).read_bytes())
    assert grid.shape == (6 * 66 - 2, 9 * 66 - 2, 3) and grid.std() > 10


@pytest.mark.parametrize("model", ["IAN_simple", "IAN"])
def test_inference_functions_match_the_models(model):
    from npe_tpu_torch.training.sample import make_inference_functions

    tm = get_config(CONFIGS[model][1])
    v = tm.init(torch.Generator().manual_seed(0), "cpu")
    fns = make_inference_functions(tm)
    z = torch.from_numpy(np.random.RandomState(1).randn(2, tm.cfg["num_latents"]).astype(np.float32))
    x = fns["sample"](v, z)
    assert x.shape == (2, 3, 64, 64) and not x.requires_grad
    assert torch.equal(fns["sampleZ"](v, z), tm.decode(v, z))
    assert torch.equal(fns["Zfn"](v, x), tm.encode_pre_iaf(v, x))
    assert torch.equal(fns["Z_IAF_fn"](v, z), tm.iaf(v, z)[0])


def test_export_cli_writes_disjoint_splits(tmp_path, capsys):
    from npe_tpu_torch.data import export

    export.main(["--out", str(tmp_path), "--dataset", "synthetic", "--train", "10", "--valid", "6"])
    assert "train: (10, 3, 64, 64)" in capsys.readouterr().out
    with np.load(tmp_path / "train.npz") as f, np.load(tmp_path / "valid.npz") as g:
        train, valid = f["arr_0"], g["arr_0"]
    assert train.shape == (10, 3, 64, 64) and valid.shape == (6, 3, 64, 64) and train.dtype == np.uint8
    assert not any(np.array_equal(a, b) for a in train for b in valid)
    ds = TT.get_dataset(str(tmp_path / "train.npz"))
    np.testing.assert_array_equal(ds.get_data(np.arange(10)), train)


def test_current_lr_and_restore_masks_mirror_npe_tpu():
    for cfg in ({"learning_rate": {0: 2e-4, 2: 1e-4}, "decay_rate": 0}, {"learning_rate": 2e-4, "decay_rate": 0.1}):
        lr_t = lr_j = 2e-4
        for epoch in range(4):
            lr_t, lr_j = TT.current_lr(cfg, epoch, lr_t), JT.current_lr(cfg, epoch, lr_j)
            assert lr_t == lr_j
    fresh = {"parts": {"state": {"a.weights_mask": 1, "b.mean": 2}}}
    loaded = TT.restore_masks({"parts": {"state": {"b.mean": 3}}}, fresh)
    assert loaded["parts"]["state"] == {"b.mean": 3, "a.weights_mask": 1}
    assert TT.GEN_KEYS == JT.GEN_KEYS and TT.DISCRIM_KEYS == JT.DISCRIM_KEYS


def test_async_checkpoint_saves_the_state_it_was_given_while_training_goes_on(tmp_path):
    """A deliberately slow save is in flight while two more steps run: the
    file holds epoch N's values, not N+1's, because no step writes into the
    tensors of the state it was given."""
    tm, cfg, x_chunk, state0 = _chunk_setup(2)
    chunk_step = TTS.make_chunk_step(tm, cfg, 2)
    gen = torch.Generator().manual_seed(3)
    state_n, *_ = chunk_step(state0, x_chunk, 0, gen, LR)
    snapshot = {path: t.clone() for path, (_, t) in tckpt._flat_train_state(state_n).items()}
    gate, fname = threading.Event(), str(tmp_path / "state.npz")

    def slow_save(state):
        assert gate.wait(timeout=60)
        tckpt.save_train_state(fname, state, {"epoch": 7})

    ckptr = tckpt.AsyncCheckpointer()
    ckptr.submit(slow_save, state_n)
    state_n1, *_ = chunk_step(state_n, x_chunk, 2, gen, LR)  # trains on while the save waits
    assert _moved(state_n1["parts"]["gen"], state_n["parts"]["gen"]) > 0
    gate.set()
    ckptr.close()
    loaded = tckpt._flat_train_state(tckpt.load_train_state(fname, "cpu"))
    assert list(loaded) == list(snapshot)
    for path, t in snapshot.items():
        assert torch.equal(loaded[path][1], t), path
    assert tckpt.train_state_metadata(fname)["epoch"] == 7

    def failing(_):
        raise OSError("disk full")

    ckptr = tckpt.AsyncCheckpointer()
    ckptr.submit(failing, None)
    with pytest.raises(OSError, match="disk full"):  # surfaces on the next wait
        ckptr.close()


# --- evaluation ---------------------------------------------------------------------


@pytest.mark.parametrize("model", ["IAN_simple", "IAN"])
def test_sample_and_interp_grid_matches_jax_within_one_uint8_step(model, tmp_path):
    from npe_tpu.data import SyntheticFaces
    from npe_tpu.training.eval_grids import sample_and_interp_grid as jax_grid
    from npe_tpu_torch.training.eval_grids import sample_and_interp_grid

    jc, tc = CONFIGS[model]
    v = tp.with_bn_state(tp.jax_variables(jc), seed=2)
    dataset = SyntheticFaces(32)
    want = jax_grid(jax_config(jc), tp.as_jax(v), dataset, str(tmp_path / "jax.png"), seed=5)
    got = sample_and_interp_grid(get_config(tc), tckpt.from_reference(v, "cpu"), dataset,
                                 str(tmp_path / "port.png"), seed=5)
    assert got.shape == want.shape == (54, 3, 64, 64) and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert got.std() > 10  # a picture, not a constant
    assert (tmp_path / "port.png").stat().st_size > 1000


def test_validation_pixel_accuracy_matches_jax():
    from npe_tpu.data import SyntheticFaces
    from npe_tpu.training.evaluate import validation_pixel_accuracy as jax_eval
    from npe_tpu_torch.training.evaluate import validation_pixel_accuracy

    v = tp.with_bn_state(tp.jax_variables(tp.TINY_JAX), seed=2)
    dataset = SyntheticFaces(24)
    cfg = dict(jax_config(tp.TINY_JAX).cfg, batch_size=4, batches_per_chunk=2)
    want = jax_eval(jax_config(tp.TINY_JAX), tp.as_jax(v), dataset, cfg, max_chunks=1)
    got = validation_pixel_accuracy(get_config(tp.TINY_TORCH), tckpt.from_reference(v, "cpu"), dataset, cfg,
                                    max_chunks=1)
    assert sorted(got) == sorted(want) == ["mse", "test_error"]
    tp.assert_close(got["mse"], want["mse"], rtol=1e-4, atol=1e-6)
    tp.assert_close(got["test_error"], 1.0 - want["mse"], rtol=1e-4, atol=1e-6)
