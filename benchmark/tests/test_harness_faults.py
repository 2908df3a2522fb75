"""Whole runs of each cell on the CPU at a tiny width, the look for a card
skipped: a sound program comes out `correct`, and each fault that the cell
can have, planted where the timed path produces its answers, comes out not
correct: a step that returns its state unchanged, a step that leaves half
of the batch out and takes the mean over the rest, an answer altered where
it is produced; and, in training, faults of the window's replayed steps
alone. (One chip: no exchange between chips to leave out.) The
control, the reference in TF32 in the program's place, fails at least one
of each cell's numbers. The `cuda` test reads the control on the card at the
cells' own sizes."""

import time

import pytest
import torch

from benchmark import core
from benchmark.tests.tiny import tiny

CELLS = [w["name"] for w in core.spec()["workloads"]]


def tiny_run(cell, seconds=1.0):
    run = core.Run(cell, 2 ** 31 + 12345, seconds, 0, "cpu")
    run.config = tiny(run.config)
    if run.traffic["kind"] == "encdec":
        run.traffic["batch"] = 8
    if run.traffic["kind"] == "train":
        run.traffic["faces"] = 2048
    return run


def result(cell):
    return core.execute(tiny_run(cell), time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = result(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and list(out)[-1] == "checks"


def _steps(monkeypatch, wrap):
    from npe_tpu_torch.training import captured, train_step

    real = train_step.make_train_steps
    monkeypatch.setattr(captured, "make_train_steps", lambda *a, **k: tuple(wrap(f) for f in real(*a, **k)))


def unchanged(step):
    from npe_tpu_torch.training.train_step import copy_state

    return lambda state, x, z, noise, lr: (copy_state(state), step(state, x, z, noise, lr)[1])


def half_batch(step):
    def f(state, x, z, noise, lr):
        h = x.shape[0] // 2
        return step(state, x[:h], z[:h], noise[:h], lr)
    return f


@pytest.mark.parametrize("fault", [unchanged, half_batch])
def test_training_faults_are_not_correct(fault, monkeypatch):
    _steps(monkeypatch, fault)
    out = result("train-IANv1-fp32")
    assert not out["correct"], out["checks"]


def stale_batch(runner):
    runner.step = lambda is_gen, xb, gen: type(runner).step(runner, is_gen, runner.x, gen)


def stale_draws(runner):
    def step(is_gen, xb, gen):
        runner.x.copy_(xb)
        return runner.run(is_gen)
    runner.step = step


def unchanged_d(runner):
    runner.programs[False] = lambda: None


@pytest.mark.parametrize("fault", [unchanged_d, stale_batch, stale_draws])
def test_training_faults_in_the_windows_replays_alone_are_not_correct(fault, monkeypatch):
    """A fault that only the window's steps have (a captured program's
    replay, not the first steps that set-up runs): a D step that leaves the
    state as it was, a batch or the draws left stale in their buffers."""
    gen = core.generator("train")
    real = gen.setup

    def setup(run):
        real(run)
        fault(run.runner)

    monkeypatch.setattr(gen, "setup", setup)
    out = result("train-IANv1-fp32")
    assert not out["correct"], out["checks"]
    assert out["checks"]["loss"]["value"] <= out["checks"]["loss"]["limit"]


def altered(values):
    values = values.copy()
    values.reshape(-1)[0] += 0.05
    return values


@pytest.mark.parametrize("what", ["z", "image"])
def test_an_altered_stroke_is_not_correct(what, monkeypatch):
    from npe_tpu_torch.editor.captured import EditRunner

    real = EditRunner.paint

    def paint(self, *args):
        z, im, delta = real(self, *args)
        return (z + 0.01 * z.abs().max(), im, delta) if what == "z" else (z, altered(im), delta)

    monkeypatch.setattr(EditRunner, "paint", paint)
    out = result("edit-IAN-fused-fp32")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("encdec")])
@pytest.mark.parametrize("method", ["encode_images", "sample_at"])
def test_an_altered_answer_of_the_api_is_not_correct(cell, method, monkeypatch):
    from npe_tpu_torch.api import IAN

    real = getattr(IAN, method)
    monkeypatch.setattr(IAN, method, lambda self, x: altered(real(self, x)))
    out = result(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_number(cell):
    """The reference in TF32 in the program's place, read as a run reads
    the program, at a tiny width: at least one number over its limit."""
    run = tiny_run(cell)
    gen = core.generator(run.traffic["kind"])
    gen.setup(run)
    gen.window(run, 0.5)
    gen.release(run)
    control = gen.readings(run, "control")
    assert any(control[k] > run.limits[k] for k in run.limits), (control, run.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(cell):
    """On the card, at the cell's own size, on three seeds: the control
    fails a number on each, the program on none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (101, 202, 303):
        run = core.Run(cell, seed, 2.0, 0, "cuda")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(run.config.get("tf32"))
        gen = core.generator(run.traffic["kind"])
        gen.setup(run)
        gen.window(run, 2.0)
        gen.release(run)
        program, control = gen.readings(run, "program"), gen.readings(run, "control")
        assert all(program[k] <= run.limits[k] for k in run.limits), program
        assert any(control[k] > run.limits[k] for k in run.limits), control
