"""The editor's steps as captured programs (`npe_tpu_torch/editor/captured.py`)
on the CPU, where the runner's bodies run directly on its buffers: the whole
edit script against npe_tpu's `EditSession` for every model and form, one
runner against fresh eager strokes while the brush changes between calls, the
undo stack, forks, the sample path, `soft_patch_mask` over 0-d tensors, and
the pure `Program`'s bookkeeping (through a stand-in for the CUDA graph), and
how chip_smoke.py reads the wrappers' launches from the device kernels' names.

The cases marked `cuda` need the card and skip here. The module imports no
JAX at the top (the npe_tpu side comes through the `jax_side` fixture), so
that on a machine without JAX they run with

    python -m pytest --noconftest -m cuda tests/test_torch_edit_captured.py -q
"""

import contextlib
import pathlib

import numpy as np
import pytest
import torch

from bench_torch_edit import stroke_script
from npe_tpu_torch.api import patch_mask, soft_patch_mask
from npe_tpu_torch.editor import captured as EC
from npe_tpu_torch.editor.engine import USER_MASK_RATE, EditSession, _soft_box_profile
from npe_tpu_torch.models import get_config
from npe_tpu_torch.ops.kernels import edit_tail as et
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt
from npe_tpu_torch.utils import graphs
from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain
from npe_tpu_torch.utils.ranges import to_tanh

HERE = pathlib.Path(__file__).resolve().parent
TINY = {"IAN_simple": (str(HERE / "tiny_ian_torch.py"), "tests/tiny_ian.py"),
        "IANv1": (str(HERE / "tiny_ianv1_torch.py"), "tests/tiny_ianv1.py"),
        "IAN": (str(HERE / "tiny_ian_full_torch.py"), "tests/tiny_ian_full.py")}
# every model and form EditSession runs
FORMS = {"IAN_simple": ("IAN_simple", {}), "IANv1 hybrid": ("IANv1", {"head_mode": "hybrid"}),
         "IANv1 fused": ("IANv1", {"head_mode": "fused"}), "IAN plain": ("IAN", {"mdblock_mode": "plain"}),
         "IAN fused": ("IAN", {"mdblock_mode": "fused"})}
SCROLL = (20, 20, 36, 36, +1, 0.5)
torch.set_num_threads(1)  # torch_parity.torch_threads' rule: one intra-op thread a test worker


@pytest.fixture(scope="module")
def jax_side():
    """(torch_parity, npe_tpu's EditSession), imported here so that the
    module itself imports no JAX."""
    import torch_parity
    from npe_tpu.editor.engine import EditSession as JaxSession

    return torch_parity, JaxSession


def _image(seed=3):
    return (np.random.RandomState(seed).rand(3, 64, 64).astype(np.float32) * 2 - 1) * 0.5


def _z_grid(seed=4):
    return np.random.RandomState(seed).randn(4, 4).astype(np.float32) * 0.5


def _sessions(tp, JaxSession, form):
    """npe_tpu's session (plain tail) and the port's on the CPU, on the same
    tiny variables (full IAN with its BN state moved off the identity)."""
    model, options = FORMS[form]
    config, jax_config = TINY[model]
    jv = tp.jax_variables(jax_config)
    if model == "IAN":
        jv = tp.with_bn_state(jv, seed=5)
    js = JaxSession(config=jax_config, variables=tp.as_jax(jv), dim=(4, 4), use_pallas=False)
    ts = EditSession(config=config, variables=from_reference(jv, "cpu"), dim=(4, 4), device="cpu", **options)
    return js, ts


def _assert_same_state(tp, ts, js):
    tp.assert_close(ts.Z.numpy(), np.asarray(js.Z))
    tp.assert_recon_close(ts.RECON, js.RECON)
    tp.assert_im_close(ts.IM, js.IM, ts.RECON, js.RECON)
    tp.assert_recon_close(ts.DELTA, js.DELTA)  # DELTA = xh - RECON
    np.testing.assert_array_equal(ts.USER_MASK, js.USER_MASK)
    assert len(ts._undo) == len(js._undo) and ts.sample_flag == js.sample_flag


@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_whole_script_matches_npe_tpu(jax_side, form):
    """chip_smoke.py's script through the runner's bodies on the CPU and
    through npe_tpu's jitted steps, state held after every operation: infer,
    the 16 strokes (boxes of 4 to 20 pixels, sigma 0 and 0.5), a scroll,
    set_latents; then the port alone samples (the packages draw other
    latents) and undoes it; then both undo set_latents."""
    tp, JaxSession = jax_side
    js, ts = _sessions(tp, JaxSession, form)
    script = ([("infer", (_image(),))] + [("paint_stroke", s) for s in stroke_script()]
              + [("scroll_patch", SCROLL), ("set_latents", (_z_grid(),))])
    for op, args in script:
        if op == "set_latents":
            z_scrolled = ts.Z.clone()
        getattr(js, op)(*args)
        getattr(ts, op)(*args)
        _assert_same_state(tp, ts, js)
    ts.sample(11)
    assert ts.sample_flag
    np.testing.assert_array_equal(ts.IM, ts.decode_current())
    ts.undo()
    _assert_same_state(tp, ts, js)
    js.undo()
    ts.undo()
    _assert_same_state(tp, ts, js)
    assert torch.equal(ts.Z, z_scrolled)
    # the decodes: infer's, sample's and decode_current's
    assert {k: p.calls for k, p in ts.runner.programs.items()} == {"paint": 16, "scroll": 1, "composite": 1,
                                                                   "encode": 1, "decode": 3}
    assert all(p.captures == 0 and p.graph is None for p in ts.runner.programs.values())  # no graph on the CPU


def _tiny_runner(model="IAN_simple", **options):
    config = TINY[model][0]
    module = get_config(config)
    seeded = module.init(torch.Generator().manual_seed(0), "cpu")
    variables = from_reference(unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1), "cpu")
    return module, variables, EC.EditRunner(module, variables, torch.float32, options, "cpu")


def _eager_stroke(module, variables, z, recon, error, um, box, sigma, rgb, composite, options):
    """A stroke as the session took it before the runner, with the box,
    sigma and the step factor as Python numbers: (z2, IM, DELTA)."""
    c1, r1, c2, r2 = box

    def decode(zf):
        return module.decode(variables, zf[None], **options)[0].permute(1, 2, 0).contiguous()

    zl = z.detach().requires_grad_(True)
    xh = decode(zl)
    m = soft_patch_mask(64, 64, c1, r1, c2, r2, float(sigma), xh.dtype, "cpu")
    loss = (((torch.from_numpy(rgb) - xh) ** 2) * m[:, :, None]).sum() / (m.sum() * 3)
    (g,) = torch.autograd.grad(loss, zl)
    with torch.no_grad():
        z2 = z - EC.PAINT_WEIGHT * g * (1.0 + (c2 - c1))
        xh = decode(z2)
        im = et.edit_tail(xh, recon, error, torch.from_numpy(um), EC.MASK_SIGMA) if composite else xh
    return z2, im.permute(2, 0, 1).numpy(), (xh - recon).permute(2, 0, 1).numpy()


@pytest.mark.parametrize("model", ["IAN_simple", "IANv1"])
def test_one_runner_with_a_changing_brush_equals_fresh_eager_strokes(model):
    """The baked-value trap: one runner called from one state with a box,
    sigma, colour and composite flag that change at every call, each result
    equal bit for bit to an eager stroke that takes them as Python numbers."""
    module, variables, runner = _tiny_runner(model)
    rng = np.random.RandomState(8)
    z = torch.from_numpy(rng.randn(16).astype(np.float32))
    recon = torch.from_numpy(rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32))
    error = torch.from_numpy(rng.uniform(-0.1, 0.1, (64, 64, 3)).astype(np.float32))
    um = np.zeros((64, 64), np.float32)
    for i, (x1, y1, x2, y2, rgb, sigma) in enumerate(stroke_script()[:6]):
        um = np.minimum(um + USER_MASK_RATE * _soft_box_profile(um.shape, x1, y1, x2, y2, sigma), 1.0)
        rgb_tanh = to_tanh(np.float32(rgb))
        composite = i % 3 != 2
        got = runner.paint(z, recon, error, um, (x1, y1, x2, y2), sigma, rgb_tanh, composite)
        want = _eager_stroke(module, variables, z, recon, error, um, (x1, y1, x2, y2), sigma, rgb_tanh, composite,
                             {})
        assert torch.equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    assert runner.programs["paint"].calls == 6


def test_undo_restores_z_exactly_and_no_step_writes_a_snapshot():
    """Every tensor the undo stack holds keeps its value through later
    strokes, scrolls and latent edits, and undo brings back the exact Z."""
    module, variables, _ = _tiny_runner()
    s = EditSession(TINY["IAN_simple"][0], variables=variables, dim=(4, 4), device="cpu")
    s.infer(_image())
    strokes = stroke_script()
    zs, held = [], []
    for i in range(5):
        zs.append(s.Z.clone())
        s.paint_stroke(*strokes[i])
        z, _, recon, error, *_ = s._undo[-1]
        held.append([(t, t.clone()) for t in (z, recon, error)])
    s.scroll_patch(*SCROLL)
    s.set_latents(_z_grid())
    assert s.Z.data_ptr() not in {s.runner.z.data_ptr(), s.runner.out.data_ptr()}
    for pairs in held:
        assert all(torch.equal(t, copy) for t, copy in pairs)
    s.undo()
    s.undo()
    for z in reversed(zs):
        s.undo()
        assert torch.equal(s.Z, z)


def test_a_fork_shares_the_runner_and_keeps_its_own_state():
    """The counterpart of tests/test_editor.py's fork test: the fork shares
    the weights and the runner, and strokes of the fork between the
    parent's leave the parent's results those of a session alone."""
    _, variables, _ = _tiny_runner()
    config = TINY["IAN_simple"][0]
    parent = EditSession(config, variables=variables, dim=(4, 4), device="cpu")
    alone = EditSession(config, variables=variables, dim=(4, 4), device="cpu")
    fork = parent.fork()
    assert fork.runner is parent.runner and fork.variables is parent.variables and not fork.can_undo
    assert alone.runner is not parent.runner
    strokes = stroke_script()
    for s in (parent, alone):
        s.infer(_image())
    fork.infer(_image(5))
    for i in range(4):
        parent.paint_stroke(*strokes[i])
        alone.paint_stroke(*strokes[i])
        fork.paint_stroke(*strokes[-1 - i])
        fork.scroll_patch(*SCROLL)
        assert torch.equal(parent.Z, alone.Z)
        np.testing.assert_array_equal(parent.IM, alone.IM)
        np.testing.assert_array_equal(parent.DELTA, alone.DELTA)
    assert not torch.equal(parent.Z, fork.Z)


def test_the_sample_path_shows_the_raw_decode():
    """After `sample`, a stroke and a latent edit show the decode of the new
    Z (npe_tpu's composite=False), and edit_tail still runs on the CPU's
    plain path, counting no launch."""
    _, variables, _ = _tiny_runner("IANv1")
    s = EditSession(TINY["IANv1"][0], variables=variables, dim=(4, 4), device="cpu")
    s.infer(_image())
    s.sample(7)
    before = (et.edit_tail.launches, rt.rgb_beta_tail.launches)
    im = s.paint_stroke(5, 5, 15, 15, (0, 0, 255), 0.5)
    np.testing.assert_array_equal(im, s.decode_current())
    im = s.set_latents(_z_grid())
    np.testing.assert_array_equal(im, s.decode_current())
    assert (et.edit_tail.launches, rt.rgb_beta_tail.launches) == before
    s.undo()
    s.undo()
    s.undo()
    assert not s.sample_flag
    im = s.set_latents(_z_grid())
    assert not np.array_equal(im, s.decode_current())  # the composite again


@pytest.mark.parametrize("box,sigma", [((10, 10, 20, 20), 0.0), ((30, 5, 50, 25), 0.5), ((0, 40, 12, 64), 1.5),
                                       ((-3, 60, 4, 70), 3.0)])
def test_soft_patch_mask_given_0d_tensors_equals_it_given_numbers(box, sigma):
    """The box and sigma as 0-d float32 tensors (the runner's buffers) give
    the masks of Python numbers exactly, and read nothing to the host."""
    from test_torch_captured import no_host_reads

    values = torch.tensor([*box, sigma], dtype=torch.float32)
    c1, r1, c2, r2, sig = values.unbind()
    with pytest.MonkeyPatch.context() as mp, no_host_reads(mp):
        soft = soft_patch_mask(64, 64, c1, r1, c2, r2, sig, torch.float32, "cpu")
        hard = patch_mask(64, 64, c1, r1, c2, r2, torch.float32, "cpu")
    assert torch.equal(soft, soft_patch_mask(64, 64, *box, sigma, torch.float32, "cpu"))
    assert torch.equal(hard, patch_mask(64, 64, *box, torch.float32, "cpu"))


@pytest.mark.parametrize("kind", EC.KINDS)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_a_step_reads_no_device_value_to_the_host(form, kind):
    """Each body of each model and form under a guard that raises on any
    read of a tensor's value to the host: what a CUDA graph cannot take."""
    from test_torch_captured import no_host_reads

    model, options = FORMS[form]
    _, _, runner = _tiny_runner(model, **options)
    runner.inputs.copy_(torch.linspace(0, 1, runner.inputs.numel()))
    for name, value in zip(EC.SCALARS, (10.0, 12.0, 30.0, 25.0, 0.5, 1.0, -1.0)):
        getattr(runner, name).fill_(value)
    for t in (runner.z, runner.recon, runner.error, runner.image):
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(2)))
    with pytest.MonkeyPatch.context() as mp, no_host_reads(mp):
        getattr(runner, f"_{kind}")()
    images = {"paint": 2, "encode": 0}.get(kind, 1)
    written = runner.zdim + images * 3 * runner.h * runner.w  # z, IM (and DELTA)
    assert torch.isfinite(runner.out[:written]).all()


def test_full_width_ian_simple_stroke_matches_npe_tpu(jax_side):
    tp, JaxSession = jax_side
    js = JaxSession(config="IAN_simple", variables=tp.jax_variables("IAN_simple"), dim=(10, 10), use_pallas=False)
    ts = EditSession(config="IAN_simple", variables=tp.port_variables("IAN_simple"), dim=(10, 10), device="cpu")
    for s in (js, ts):
        s.infer(_image())
        s.paint_stroke(12, 30, 28, 41, (40, 200, 90), 0.5)
    _assert_same_state(tp, ts, js)
    assert np.abs(ts.DELTA).max() > 1e-2


# --- the pure Program's bookkeeping, through a stand-in for the CUDA graph ----


class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


@contextlib.contextmanager
def _fake_capture(graph, pool=None, stream=None, capture_error_mode="global"):
    _fake_capture.modes.append(capture_error_mode)
    yield


def test_a_pure_program_captures_after_its_eager_first_call_and_replays_later(monkeypatch):
    """A pure body that launches the tail kernel twice: the first call runs
    it eagerly (its result stands, its 2 launches count) and then captures
    it, which counts nothing of its own; every later call replays and counts
    2; the body runs twice in all. A capture that fails raises and leaves the
    counts where the eager call put them."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(graphs, "_on", lambda stream: contextlib.nullcontext())
    _fake_capture.modes = []
    runs = []

    def body():
        runs.append(1)
        rt.count_launch(rt.rgb_beta_tail, torch.float32)
        rt.count_launch(rt.rgb_beta_tail, torch.float32)

    program = graphs.Program(body, stream=object(), pure=True)
    start, replays = rt.rgb_beta_tail.launches, _FakeGraph.replays
    counts = []
    for _ in range(3):
        program()
        counts.append(rt.rgb_beta_tail.launches - start)
        if program.calls == 1:
            assert program.captures == 1 and _FakeGraph.replays == replays
    assert counts == [2, 4, 6] and len(runs) == 2 and _FakeGraph.replays - replays == 2
    assert (program.calls, program.captures) == (3, 1) and _fake_capture.modes == ["thread_local"]

    calls = []

    def failing():
        calls.append(1)
        rt.count_launch(rt.rgb_beta_tail, torch.bfloat16)
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is capturing")

    program = graphs.Program(failing, stream=object(), pure=True)
    before = rt.rgb_beta_tail.launches_bf16
    with pytest.raises(RuntimeError, match="capturing"):
        program()
    assert rt.rgb_beta_tail.launches_bf16 == before + 1 and program.graph is None and len(calls) == 2


def test_the_editor_captures_thread_local_and_the_trainer_in_the_default_mode(monkeypatch):
    """The editor's programs capture with capture_error_mode "thread_local",
    and so, since the trainer's own subclass went, do the trainer's (its
    asynchronous checkpoint thread is the case that mode is for)."""
    from npe_tpu_torch.training import captured as trainer

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(graphs, "_on", lambda stream: contextlib.nullcontext())
    _fake_capture.modes = []
    assert trainer.Program is graphs.Program
    for program in (graphs.Program(lambda: None, stream=object(), pure=True),
                    trainer.Program(lambda: None, stream=object())):
        program()
        program()
    assert _fake_capture.modes == ["thread_local", "thread_local"]


def test_chip_smoke_reads_each_wrappers_launches_from_the_device_kernels_names():
    """chip_smoke.py holds the wrappers' counts of an edit script to the
    device kernels torch.profiler records: each kernel name goes to its
    counter and form, the float32 MDBLOCK's three kernels (its prologue and
    two MDCLs, one template) make one launch, the bf16 form's MDCL kernel of
    the same name counts for nothing, nor do the head's own tail, the slice
    sums and library kernels."""
    from chip_smoke import witnessed

    kernels = {"void (anonymous namespace)::edit_tail_kernel(float const*, float const*, int)": 17,
               "void npe::rgb_beta_tail_kernel<float, float, false>(float const*, float const*, float*, int)": 35,
               "void npe::rgb_beta_tail_kernel<float, __nv_bfloat16, false>(float const*, __nv_bfloat16*, int)": 4,
               "void npe::rgb_beta_tail_kernel<float, float, true>(float const*, float const*, float*, int)": 9,
               "void (anonymous namespace)::head_trunk_kernel<float>(float const*, float const*, float*, int)": 9,
               "void (anonymous namespace)::head_trunk_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)": 3,
               **{f"void (anonymous namespace)::mdcl_kernel<{p}>(float const*, float const*, float const*, "
                  "(anonymous namespace)::Fwd, CUtensorMap_st, CUtensorMap_st)": 105 for p in range(3)},
               "void (anonymous namespace)::mdcl_kernel<2, true, 256>((anonymous namespace)::Mdcl, CUtensorMap)": 6,
               "void (anonymous namespace)::prologue_kernel(__nv_bfloat16 const*, float const*, int)": 3,
               "void (anonymous namespace)::add_slices_kernel<1>(float const*, float const*, float const*, float*, "
               "(anonymous namespace)::Fwd)": 50,
               "void (anonymous namespace)::stage_kernel<long long>(unsigned int const*, long long const*, int)": 2,
               "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(int, int, int)": 70}
    assert witnessed(kernels) == {"edit_tail": 17, "rgb_beta_tail": 35, "rgb_beta_tail_bf16": 4, "rgb_beta_head": 9,
                                  "rgb_beta_head_bf16": 3, "mdblock": 105, "mdblock_bf16": 3, "staging": 2}
    assert witnessed({}) == {}


def test_a_session_refuses_a_latent_grid_or_a_colour_of_another_size():
    """The runner's buffers would broadcast a one-latent grid; the session
    raises instead, before it pushes an undo snapshot."""
    _, variables, _ = _tiny_runner()
    s = EditSession(TINY["IAN_simple"][0], variables=variables, dim=(4, 4), device="cpu")
    s.infer(_image())
    for bad in (np.zeros((1, 1), np.float32), np.zeros((5, 5), np.float32)):
        with pytest.raises(ValueError, match="latents"):
            s.set_latents(bad)
    with pytest.raises(ValueError, match="rgb"):
        s.paint_stroke(1, 1, 9, 9, (255, 0))
    assert not s.can_undo


def test_a_session_on_the_cpu_makes_no_graph():
    _, variables, _ = _tiny_runner()
    s = EditSession(TINY["IAN_simple"][0], variables=variables, dim=(4, 4), device="cpu")
    assert all(p.stream is None for p in s.runner.programs.values())
    assert not s.runner.staging.is_pinned()


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def _deterministic():
    old = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=True)
        torch.backends.cudnn.deterministic = old[1]


def _card_script(s):
    s.infer(_image())
    for stroke in stroke_script():
        s.paint_stroke(*stroke)
    painted = (s.Z.cpu().numpy(), s.IM, s.DELTA, s.RECON)
    s.scroll_patch(*SCROLL)
    s.set_latents(_z_grid())
    s.sample(11)
    s.undo()
    return painted + (s.Z.cpu().numpy(), s.IM)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_captured_session_captures_once_and_equals_eager_on_the_card(cuda, form, dtype):
    """The script on the tiny profiles, captured and through the runner's
    bodies called eagerly, from the same weights, under deterministic
    algorithms: equal bit for bit; each program captured once, while the
    brush moved, resized and switched sigma; a fork made after adds none."""
    model, options = FORMS[form]
    _, variables, _ = _tiny_runner(model)
    variables = {k: v.to(cuda) for k, v in variables.items()}
    with _deterministic():
        captured, eager = (EditSession(TINY[model][0], variables=variables, dim=(4, 4), device=cuda, dtype=dtype,
                                       eager=e, **options) for e in (False, True))
        got, want = _card_script(captured), _card_script(eager)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(p.captures == 1 for p in captured.runner.programs.values())
    assert all(p.captures == 0 for p in eager.runner.programs.values())
    fork = captured.fork()
    fork.infer(_image(5))
    fork.paint_stroke(3, 3, 9, 9, (1, 2, 3), 0.5)
    fork.set_latents(_z_grid(6))
    assert all(p.captures == 1 for p in captured.runner.programs.values())
