"""The port's spans (`npe_tpu_torch/utils/profiling.py:annotate`) on the CPU:
off (the shared null context, `record_function` never called) while no
profiler runs; under a CPU `torch.profiler.profile`, each entry point's spans
nested as the host calls them (each event's `cpu_parent`), through the
plain calls and through a stand-in CUDA graph whose replay runs the body;
and the same results bit for bit with the profiler on and off. The `cuda`
case (no `npe.capture` in a warm window) runs on the card. This file imports
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import contextlib
import pathlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from npe_tpu_torch.api import IAN
from npe_tpu_torch.editor.engine import EditSession
from npe_tpu_torch.models import get_config
from npe_tpu_torch.ops.kernels import staging
from npe_tpu_torch.training import captured as C
from npe_tpu_torch.training import train as TT
from npe_tpu_torch.training import train_step as TTS
from npe_tpu_torch.utils import graphs, profiling
from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain

HERE = pathlib.Path(__file__).resolve().parent
TINY = str(HERE / "tiny_ian_torch.py")
TINY_V1 = str(HERE / "tiny_ianv1_torch.py")
TINY_FULL = str(HERE / "tiny_ian_full_torch.py")
STROKES = [(2, 3, 14, 17, (200, 40, 90), 0.0), (30, 8, 50, 24, (10, 220, 130), 0.5),
           (5, 40, 21, 60, (120, 120, 250), 0.0), (44, 44, 60, 62, (0, 0, 0), 0.5)]


def _variables(config, device="cpu"):
    seeded = get_config(config).init(torch.Generator().manual_seed(0), "cpu")
    return from_reference(unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1), device)


def _image(seed=3):
    return (np.random.RandomState(seed).rand(3, 64, 64).astype(np.float32) * 2 - 1) * 0.5


def _profiled(fn):
    """fn() under a CPU profiler: (its result, {span name: [parent names]})
    of the `npe.*` spans recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _spans(prof):
    spans = {}
    for ev in prof.events():
        if ev.name.startswith("npe.") and ev.device_type == DeviceType.CPU:  # not the card's copy of a span
            parent = ev.cpu_parent
            while parent is not None and not parent.name.startswith("npe."):
                parent = parent.cpu_parent
            spans.setdefault(ev.name, []).append(None if parent is None else parent.name)
    return spans


class _Replayer:
    """A stand-in CUDA graph: its replay runs the body it was captured from."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Every `Program` given a stream takes the card's path on the CPU: an
    eager first call, a capture that keeps the body, replays that run it."""
    monkeypatch.setattr(graphs, "_on", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "capture", lambda body, stream, pool: (_Replayer(body), [0] * len(graphs.COUNTERS)))

    def give_streams(programs):
        for p in programs:
            p.stream = object()

    return give_streams


def _edit(config=TINY):
    s = EditSession(config, variables=_variables(config), dim=(4, 4), device="cpu")
    s.infer(_image())
    return s


def _api():
    return IAN(TINY_V1, variables=_variables(TINY_V1), device="cpu")


def _runner(steps=4):
    module = get_config(TINY_V1)
    cfg = dict(module.cfg, batch_size=4)
    x = torch.from_numpy(np.random.RandomState(11).uniform(-0.8, 0.8, (steps * 4, 3, 64, 64)).astype(np.float32))
    state = TTS.init_train_state(module, _variables(TINY_V1), cfg)
    runner = C.StepRunner(module, cfg, state, x)
    runner.begin(state, 2e-4)
    return runner, x


def _steps(runner, x, steps=4):
    gen = torch.Generator().manual_seed(21)
    return torch.stack([runner.step(i % 2 == 0, x[i * 4:(i + 1) * 4], gen) for i in range(steps)])


def _u8():
    return torch.from_numpy(np.random.RandomState(2).randint(0, 256, (6, 3, 64, 64)).astype(np.uint8))


def test_annotate_is_one_shared_null_context_without_a_profiler():
    assert profiling.annotate("npe.a") is profiling.annotate("npe.b") is profiling._OFF
    with profiling.annotate("npe.a"), profiling.annotate("npe.a"):  # reusable and reentrant
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.annotate("npe.a"), torch.autograd.profiler.record_function)
    assert profiling.annotate("npe.a") is profiling._OFF


ENTRIES = {
    "paint_stroke": lambda: _edit().paint_stroke(*STROKES[0]),
    "encode_images_and_sample_at": lambda: (lambda api: api.sample_at(api.encode_images(_image()[None])))(_api()),
    "step_G_and_D": lambda: _steps(*_runner(2), steps=2),
    "stage_chunk": lambda: staging.stage_chunk(_u8(), np.array([3, 0, 5])),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entries_run_without_record_function_when_no_profiler_runs(entry, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    ENTRIES[entry]()


def test_an_edit_session_nests_its_spans():
    s = _edit()
    _, spans = _profiled(lambda: s.paint_stroke(*STROKES[0]))
    assert spans == {"npe.paint_stroke": [None], "npe.stage": ["npe.paint_stroke"],
                     "npe.eager": ["npe.paint_stroke"], "npe.unpack": ["npe.paint_stroke"]}
    # the other edits run in no cell's window and carry no span of their own
    for edit in (lambda: s.set_latents(np.zeros((4, 4), np.float32)), lambda: s.scroll_patch(4, 4, 20, 20, 1)):
        _, spans = _profiled(edit)
        assert spans == {"npe.stage": [None], "npe.eager": [None], "npe.unpack": [None]}
    _, spans = _profiled(lambda: s.infer(_image(4)))
    assert spans == {"npe.eager": [None, None], "npe.stage": [None], "npe.unpack": [None]}  # the encode, the decode
    _, spans = _profiled(lambda: s.RECON)
    assert spans == {}


def test_a_replayed_stroke_nests_stage_replay_and_unpack(stand_in_graphs):
    s = _edit()
    stand_in_graphs(s.runner.programs.values())
    _, first = _profiled(lambda: s.paint_stroke(*STROKES[0]))
    _, second = _profiled(lambda: s.paint_stroke(*STROKES[1]))
    assert first["npe.eager"] == first["npe.capture"] == ["npe.paint_stroke"] and "npe.replay" not in first
    assert second == {"npe.paint_stroke": [None], "npe.stage": ["npe.paint_stroke"],
                      "npe.replay": ["npe.paint_stroke"], "npe.unpack": ["npe.paint_stroke"]}
    assert s.runner.programs["paint"].captures == 1


@pytest.mark.parametrize("graph", ["direct", "stand-in"])
def test_the_api_nests_its_spans(graph, stand_in_graphs):
    api = _api()
    z = np.zeros((1, 16), np.float32)
    calls = {"npe.encode_images": lambda: api.encode_images(_image()[None]),
             "npe.sample_at": lambda: api.sample_at(z),
             "imgrad": lambda: api.imgrad(2, 2, 9, 9, z),
             "imgradRGB": lambda: api.imgradRGB(2, 2, 9, 9, (0.1, 0, 0), z)}
    if graph == "stand-in":
        for fn in calls.values():
            fn()  # makes each signature, whose Program then takes the card's path
        stand_in_graphs(sig.program for sig in api.programs.signatures.values())
        for fn in calls.values():
            fn()  # the eager first call and the capture
    run = "npe.eager" if graph == "direct" else "npe.replay"
    for name, fn in calls.items():
        _, spans = _profiled(fn)
        if name.startswith("npe."):
            assert spans == {name: [None], "npe.stage": [name], run: [name], "npe.unpack": [name]}, name
        else:  # no cell runs the gradients: their programs' spans stand alone
            assert spans == {"npe.stage": [None], run: [None], "npe.unpack": [None]}, name


def test_steps_and_stage_chunk_nest_their_spans(stand_in_graphs):
    runner, x = _runner(4)
    _, spans = _profiled(lambda: _steps(runner, x, 2))
    assert spans == {"npe.step.G": [None], "npe.step.D": [None], "npe.eager": ["npe.step.G", "npe.step.D"]}
    stand_in_graphs(runner.programs.values())
    runner.programs[True].calls = runner.programs[False].calls = 0
    _, spans = _profiled(lambda: _steps(runner, x, 4))
    assert spans["npe.eager"] == ["npe.step.G", "npe.step.D"]
    assert spans["npe.capture"] == ["npe.step.G", "npe.step.D"]  # a step that updates its state captures at its 2nd
    assert spans["npe.replay"] == ["npe.step.G", "npe.step.D"]
    _, spans = _profiled(lambda: staging.stage_chunk(_u8(), np.array([3, 0, 5])))
    assert spans == {"npe.stage_chunk": [None], "npe.wait": ["npe.stage_chunk"]}
    _, spans = _profiled(lambda: staging.stage_uint8_to_tanh(_u8()))
    assert spans == {}  # the server's captured encode calls it


def test_the_trainers_traced_chunk_holds_the_spans(tmp_path, monkeypatch):
    kept = []
    traced = profiling.device_trace

    @contextlib.contextmanager
    def keep(log_dir):
        with traced(log_dir) as prof:
            yield prof
        kept.append(prof)

    monkeypatch.setattr(profiling, "device_trace", keep)
    TT.train(TINY_V1, "synthetic", max_epochs=1, num_examples=16, out_dir=str(tmp_path), checkpoint_grids=False,
             device="cpu", profile_dir=str(tmp_path / "trace"), cfg_overrides={"batch_size": 4, "batches_per_chunk": 2})
    (prof,) = kept
    spans = _spans(prof)
    assert spans["npe.chunk"] == [None]
    assert spans["npe.stage_chunk"] == ["npe.chunk"] and spans["npe.step.G"] == spans["npe.step.D"] == ["npe.chunk"]
    # the G / D weights up and the metrics down, the indices up
    assert sorted(spans["npe.wait"]) == ["npe.chunk", "npe.chunk", "npe.stage_chunk"]
    assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1


def _flat_state(state):
    return [t for _, t in C.flatten(state)]


@pytest.mark.parametrize("graph", ["direct", "stand-in"])
def test_steps_are_bit_identical_with_the_profiler_on_and_off(graph, stand_in_graphs):
    out = []
    for traced in (False, True):
        runner, x = _runner(4)
        if graph == "stand-in":
            stand_in_graphs(runner.programs.values())
        rows = _profiled(lambda: _steps(runner, x))[0] if traced else _steps(runner, x)
        out.append((rows, _flat_state(runner.state)))
    (rows_off, state_off), (rows_on, state_on) = out
    assert torch.equal(rows_off, rows_on) and torch.isfinite(rows_on).all()
    assert len(state_off) == len(state_on) and all(torch.equal(a, b) for a, b in zip(state_off, state_on))


def test_strokes_are_bit_identical_with_the_profiler_on_and_off(stand_in_graphs):
    out = []
    for traced in (False, True):
        s = _edit(TINY_FULL)
        stand_in_graphs(s.runner.programs.values())

        def strokes(s=s):
            return [(s.paint_stroke(*stroke).copy(), s.Z.clone()) for stroke in STROKES]

        out.append(_profiled(strokes)[0] if traced else strokes())
    for (im_off, z_off), (im_on, z_on) in zip(*out):
        np.testing.assert_array_equal(im_off, im_on)
        assert torch.equal(z_off, z_on)


@pytest.mark.cuda
def test_a_warm_window_on_the_card_records_no_capture():
    """After warm-up, 20 strokes and 20 steps under the profiler: every call
    a replay, none a capture, and the spans of a stroke nested as the host
    calls them, the synchronise among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    s = EditSession(TINY_FULL, variables=_variables(TINY_FULL, cuda), dim=(4, 4), device=cuda)
    s.infer(_image())
    for stroke in STROKES:
        s.paint_stroke(*stroke)
    module = get_config(TINY_V1)
    cfg = dict(module.cfg, batch_size=4)
    x = torch.from_numpy(np.random.RandomState(11).uniform(-0.8, 0.8, (8, 3, 64, 64)).astype(np.float32)).to(cuda)
    state = TTS.init_train_state(module, _variables(TINY_V1, cuda), cfg)
    runner = C.StepRunner(module, cfg, state, x)
    runner.begin(state, 2e-4)
    gen = torch.Generator(cuda).manual_seed(21)
    for i in range(4):  # eager, then captured, G and D
        runner.step(i % 2 == 0, x[(i % 2) * 4:(i % 2 + 1) * 4], gen)
    torch.cuda.synchronize()

    def window():
        for i in range(20):
            s.paint_stroke(*STROKES[i % len(STROKES)])
            runner.step(i % 2 == 0, x[(i % 2) * 4:(i % 2 + 1) * 4], gen)
        torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        window()
    spans = _spans(prof)
    assert "npe.capture" not in spans and "npe.eager" not in spans
    assert len(spans["npe.replay"]) == 40
    assert sorted(set(spans["npe.replay"])) == ["npe.paint_stroke", "npe.step.D", "npe.step.G"]
    for name in ("npe.stage", "npe.wait", "npe.unpack"):
        assert spans[name] == ["npe.paint_stroke"] * 20, name
    assert all(p.captures == 1 for p in runner.programs.values()) and s.runner.programs["paint"].captures == 1
