"""The plain reference against the port's plain forms, on the CPU at a tiny
width: the same variables (the benchmark's `init`), the same inputs; in
float64 where both sides compute the same mathematics in another order, so
that any gap is a difference of mathematics."""

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.reference import editor as ref_editor
from benchmark.reference.models import Model, init, layout
from benchmark.reference.training import Trainer, init_adam
from benchmark.tests.tiny import tiny

CONFIGS = {c["name"]: core.load_json(core.ROOT / c["file"]) for c in core.spec()["configs"]}


def port(cfg):
    from npe_tpu_torch.models import get_config

    return get_config(cfg["model"])


def f64(v):
    return {k: t.double() if t.is_floating_point() else t for k, t in v.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_draws_the_ports_variables(name):
    """Names and shapes of the port's own `init` at the published widths."""
    cfg = CONFIGS[name]
    theirs = port(cfg).init(torch.Generator().manual_seed(0), "cpu")
    ours = {n: tuple(s) for n, s, _, _ in layout(cfg)}
    assert {k: tuple(t.shape) for k, t in theirs.items()} == ours
    mine = init(tiny(cfg), 3, "cpu")
    masks = [k for k in theirs if k.endswith(".weights_mask")]
    assert all(torch.equal(mine[k], theirs[k]) for k in masks)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_and_decode(name):
    cfg = tiny(CONFIGS[name])
    v = f64(init(cfg, 5, "cpu"))
    module, ref = port(cfg), Model(cfg)
    x = torch.tanh(torch.randn((3, *cfg["image"]), generator=torch.Generator().manual_seed(1), dtype=torch.float64))
    z = module.encode(v, x)
    torch.testing.assert_close(ref.encode(v, x), z, rtol=1e-10, atol=1e-10)
    forms = {"head_mode": "plain", **({"mdblock_mode": "plain"} if cfg["decoder"]["kind"] == "mdblock" else {})}
    # the port places an MDCL's scale-0 branch with a float32 1/9 (8e-9 off), whatever the dtype
    torch.testing.assert_close(ref.decode(v, z), module.decode(v, z, **forms), rtol=1e-7, atol=1e-8)


def test_stroke_against_the_editor():
    """One stroke of the port's EditRunner (its plain versions on the CPU) in
    float32 against the reference's, from the same state."""
    from npe_tpu_torch.editor.engine import EditSession

    cfg = tiny(CONFIGS["IAN-fused-fp32"])
    v = init(cfg, 6, "cpu")
    session = EditSession(config=cfg["model"], variables=v, dim=(10, 10), device="cpu", **cfg["forms"])
    face = np.tanh(np.random.RandomState(2).randn(3, 64, 64)).astype(np.float32)
    session.infer(face)
    ref = Model(cfg)
    for box, sigma, rgb in (((3, 5, 19, 14), 0.0, (250, 10, 40)), ((30, 40, 38, 60), 0.5, (0, 128, 255))):
        z, recon, error = session.Z, session._recon, session._error
        session.paint_stroke(*box, rgb, sigma)
        mask = torch.from_numpy(session.USER_MASK)
        z2, shown, delta = ref_editor.stroke(ref, v, z, recon, error, mask, box, sigma,
                                             2.0 * (np.float32(rgb) / 255.0) - 1.0)
        step = float((z2 - z).abs().max())
        assert float((session.Z - z2).abs().max()) <= 1e-3 * step
        np.testing.assert_allclose(session.IM, shown.numpy(), atol=1e-5)
        np.testing.assert_allclose(session.DELTA, delta.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_training_steps(name, monkeypatch):
    """Three steps (G, D, G) of the port's eager steps against the
    reference's, in float64 (the head's plain form: its kernel wrappers take
    float32 and bf16 alone): losses, gradients as Adam holds them, and the
    parameters and BN statistics after the three."""
    from npe_tpu_torch.models import common
    from npe_tpu_torch.training import train_step as TS

    monkeypatch.setattr(common, "HEAD_MODE", "plain")
    cfg = tiny(CONFIGS[name])
    module = port(cfg)
    tcfg = {**module.cfg, **cfg["train"], "batch_size": 4}
    v = f64(init(cfg, 7, "cpu"))
    g = torch.Generator().manual_seed(3)
    steps = TS.make_train_steps(module, tcfg)
    state = TS.init_train_state(module, dict(v), tcfg)
    trainer, ref_v, adam = Trainer(cfg), dict(v), init_adam(v)
    for i in range(3):
        x = torch.tanh(torch.randn((4, *cfg["image"]), generator=g, dtype=torch.float64))
        z_rand, noise = (torch.randn((4, cfg["num_latents"]), generator=g, dtype=torch.float64) for _ in range(2))
        state, m = steps[i % 2](state, x, z_rand, noise, 2e-4)
        ref_v, adam, terms, _ = trainer.step(ref_v, adam, x, z_rand, noise, 2e-4, is_gen=i % 2 == 0)
        for k, t in terms.items():
            torch.testing.assert_close(m[k].double(), t, rtol=1e-9, atol=1e-12)
        # full IAN's MDCLs carry the port's float32 1/9 (see above): gaps of 1e-6 of a tensor's largest value
        for part in ("gen", "latent", "discrim"):
            for k, mom in state["opt"][part]["mu"].items():
                want = adam[part]["m"][k]
                torch.testing.assert_close(mom, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()) + 1e-15)
    theirs = TS.variables_of(state)
    for k, t in ref_v.items():
        # Adam moves each element by up to lr = 2e-4 a step, whatever its gradient's size
        torch.testing.assert_close(theirs[k], t, rtol=1e-6, atol=1e-9)
