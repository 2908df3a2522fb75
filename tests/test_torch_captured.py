"""The training step as captured programs (`npe_tpu_torch/training/captured.py`)
on the CPU: the static-buffer chunk runner against the eager chunk loop, the
learning rate as a device scalar, the launch-count bookkeeping of a capture
(through a stand-in for the CUDA graph), and a guard that no step reads a
device value to the host. What needs the card is in tests/test_torch_cuda.py.

The runner and the eager loop run the same operations on the same inputs, so
they are held equal bit for bit, in float64 (the parity rule of
tests/torch_parity.py; the float64 step takes the plain RGB-Beta head, whose
kernel wrapper takes float32 only)."""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_parity as tp
from npe_tpu_torch.models import get_config
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt
from npe_tpu_torch.training import captured as C
from npe_tpu_torch.training import train as TT
from npe_tpu_torch.training import train_step as TTS
from npe_tpu_torch.utils import checkpoints as tckpt
from npe_tpu_torch.utils import graphs

tp.torch_threads()

LR = 2e-4
MODELS = {"IAN_simple": (tp.TINY_TORCH, tp.TINY_JAX), "IANv1": (tp.TINY_V1_TORCH, tp.TINY_V1_JAX),
          "IAN": (tp.TINY_FULL_TORCH, tp.TINY_FULL_JAX)}
OPTIONS = {"faithful": {}, "skip_nonfinite": {"skip_nonfinite_updates": True},
           # a threshold above chance that tiny IAN_simple's D accuracy crosses: its last D step trains G
           "guard": {"adaptive_ratio_acc": 0.51}}


def _setup(model, nb=4, bs=4, dtype=torch.float64, **overrides):
    config, jax_config = MODELS[model]
    module = get_config(config)
    if dtype == torch.float64:
        module = tp.plain_head(module)
    cfg = dict(module.cfg, batch_size=bs, **overrides)
    rng = np.random.RandomState(11)
    x_chunk = torch.from_numpy(rng.uniform(-0.8, 0.8, (nb * bs, 3, 64, 64))).to(dtype)
    variables = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tp.port_variables(jax_config).items()}
    return module, cfg, x_chunk, TTS.init_train_state(module, variables, cfg)


def _flat(state):
    return {path: t for path, (_, t) in tckpt._flat_train_state(state).items()}


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for path in fa:
        assert fa[path].dtype == fb[path].dtype and torch.equal(fa[path], fb[path]), path


def _chunks(module, cfg, nb, state0, x_chunk, guard_acc, lrs, eager):
    """len(lrs) chunks from state0, each from the last one's state: the
    (state, keys, table, flags, ema) of each, and the generator's state."""
    rows = TTS.make_chunk_rows(module, cfg, nb, guard_acc=guard_acc, eager=eager)
    gen = torch.Generator().manual_seed(21)
    ema = torch.tensor(TTS.GUARD_CHANCE) if guard_acc is not None else None
    state, out = state0, []
    for i, lr in enumerate(lrs):
        state, keys, table, flags, ema = rows(state, x_chunk, i * nb, gen, lr, ema)
        out.append((state, keys, table.clone(), flags, None if ema is None else ema.clone()))
    return out, gen.get_state(), rows


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_runner_chunk_equals_the_eager_chunk_in_float64(model, option):
    """The static-buffer runner (the captured chunk's code, each program
    called directly on the CPU) against the eager loop, from the same state,
    generator seed and batch: the state, every row of the metrics table, the
    G/D flags, the guard's EMA and the generator, bit for bit. Each row
    differs from the next, which a table of aliases of one buffer would
    not."""
    overrides = OPTIONS[option]
    nb = 4
    module, cfg, x_chunk, state0 = _setup(model, nb, **overrides)
    guard = overrides.get("adaptive_ratio_acc")
    want, want_gen, _ = _chunks(module, cfg, nb, state0, x_chunk, guard, [LR], eager=True)
    got, got_gen, rows = _chunks(module, cfg, nb, state0, x_chunk, guard, [LR], eager=False)
    (w_state, w_keys, w_table, w_flags, w_ema), = want
    (g_state, g_keys, g_table, g_flags, g_ema), = got
    assert (g_keys, g_flags) == (w_keys, w_flags)
    assert torch.equal(g_table, w_table)
    assert all(not torch.equal(g_table[i], g_table[i + 1]) for i in range(nb - 1))
    _assert_states_equal(g_state, w_state)
    assert torch.equal(got_gen, want_gen)
    if guard is not None:
        assert torch.equal(g_ema, w_ema)
    (runner,) = rows.runners.values()
    assert g_state is runner.state and runner.programs[True].graph is None  # the CPU captures nothing
    assert int(g_state["step"]) == nb and int(g_state["opt"]["latent"]["count"]) == nb
    _assert_states_equal(state0, _setup(model, nb, **overrides)[3])  # the state passed in is left as it was


def test_a_chunk_called_twice_from_its_own_state_equals_two_eager_chunks():
    """The second chunk starts from the runner's own buffers (consumed in
    place) at another learning rate, which the runner takes as its 0-d lr
    tensor: equal to two eager chunks bit for bit, and both chunks return
    the same buffers."""
    nb = 4
    module, cfg, x_chunk, state0 = _setup("IAN_simple", nb)
    lrs = [LR, torch.tensor(5e-4, dtype=torch.float64)]
    want, want_gen, _ = _chunks(module, cfg, nb, state0, x_chunk, None, lrs, eager=True)
    got, got_gen, rows = _chunks(module, cfg, nb, state0, x_chunk, None, lrs, eager=False)
    for (w_state, _, w_table, w_flags, _), (g_state, _, g_table, g_flags, _) in zip(want, got):
        assert g_flags == w_flags and torch.equal(g_table, w_table)
    _assert_states_equal(got[1][0], want[1][0])
    assert got[0][0] is got[1][0] and torch.equal(got_gen, want_gen)
    assert float(next(iter(rows.runners.values())).lr) == 5e-4
    assert int(got[1][0]["step"]) == 2 * nb


def test_chunk_step_means_are_the_rows_means():
    nb = 4
    module, cfg, x_chunk, state0 = _setup("IAN_simple", nb)
    _, keys, table, flags, _ = TTS.make_chunk_rows(module, cfg, nb, eager=True)(
        state0, x_chunk, 0, torch.Generator().manual_seed(21), LR)
    _, gen_m, dis_m, n_gen = TTS.make_chunk_step(module, cfg, nb)(
        state0, x_chunk, 0, torch.Generator().manual_seed(21), LR)
    assert n_gen == sum(flags) == 2
    for j, k in enumerate(keys):
        assert float(gen_m[k]) == pytest.approx(float(table[[0, 2], j].mean()), rel=1e-6)
        assert float(dis_m[k]) == pytest.approx(float(table[[1, 3], j].mean()), rel=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lr_as_a_0d_tensor_gives_the_float_step_bit_for_bit(dtype):
    """A G and a D step with lr a Python float and with lr a 0-d tensor (of
    the masters' dtype, and of float32 for float64 masters where the step
    casts it): the same state bit for bit where the tensor holds the same
    value."""
    module, cfg, x_chunk, state0 = _setup("IAN_simple", 1, dtype=dtype)
    rng = np.random.RandomState(4)
    z, eps = (torch.from_numpy(rng.randn(4, cfg["num_latents"])).to(dtype) for _ in range(2))
    gen_step, discrim_step = TTS.make_train_steps(module, cfg)
    states = []
    for lr in (LR, torch.tensor(LR, dtype=dtype)):
        state, _ = gen_step(state0, x_chunk, z, eps, lr)
        state, _ = discrim_step(state, x_chunk, z, eps, lr)
        states.append(state)
    _assert_states_equal(*states)
    assert any(not torch.equal(a, b) for a, b in zip(_flat(states[0]).values(), _flat(state0).values()))


def test_runner_refuses_a_state_of_another_structure():
    module, cfg, x_chunk, state0 = _setup("IAN_simple", 2)
    runner = C.StepRunner(module, cfg, state0, x_chunk)
    other = TTS.copy_state(state0)
    other["parts"]["gen"].pop(next(iter(other["parts"]["gen"])))
    with pytest.raises(ValueError, match="structure"):
        runner.begin(other, LR)
    other = TTS.copy_state(state0)
    other["step"] = other["step"].to(torch.int64)
    with pytest.raises(ValueError, match="step"):
        runner.begin(other, LR)


def test_a_dropped_runner_is_freed_without_the_cyclic_collector():
    """A chunk function's runner (its buffers and, on the card, its graphs
    and their memory pool) goes when the last reference to the chunk
    function goes, by reference counting: a runner left to the cyclic
    collector could be freed inside a later capture, whose cudaFree would
    invalidate it."""
    import gc
    import weakref

    module, cfg, x_chunk, state0 = _setup("IAN_simple", 2)
    rows = TTS.make_chunk_rows(module, cfg, 2)
    rows(state0, x_chunk, 0, torch.Generator().manual_seed(1), LR)
    (runner,) = rows.runners.values()
    alive = weakref.ref(runner)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del runner, rows
        assert alive() is None
    finally:
        if collecting:
            gc.enable()


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay runs no Python, so it
    counts nothing."""

    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


@contextlib.contextmanager
def _fake_capture(graph, pool=None, stream=None, capture_error_mode="global"):
    yield


def test_capture_adds_no_launches_and_every_replay_adds_the_captured_ones(monkeypatch):
    """A body that launches the tail kernel twice (as a decode of IANv1
    does, counted by its wrapper at Python call time): the eager first call
    counts 2, the capture counts nothing of its own and its replay 2, every
    later replay 2; the body runs twice in all (eager, then under capture).
    A capture that fails raises and leaves the counts as they were."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(graphs, "_on", lambda stream: contextlib.nullcontext())
    runs = []

    def body():
        runs.append(1)
        rt.count_launch(rt.rgb_beta_tail, torch.float32)
        rt.count_launch(rt.rgb_beta_tail, torch.float32)

    program = C.Program(body, stream=object(), pool=None)
    start, replays = rt.rgb_beta_tail.launches, _FakeGraph.replays
    counts = []
    for _ in range(4):
        program()
        counts.append(rt.rgb_beta_tail.launches - start)
    assert counts == [2, 4, 6, 8] and len(runs) == 2 and _FakeGraph.replays - replays == 3
    assert (program.calls, program.captures) == (4, 1)
    assert program.recorded == [2 if c == (rt.rgb_beta_tail, "launches") else 0 for c in C.COUNTERS]

    def failing():
        rt.count_launch(rt.rgb_beta_tail, torch.bfloat16)
        raise RuntimeError("operation not permitted when stream is capturing")

    program = C.Program(failing, stream=object())
    with pytest.raises(RuntimeError, match="capturing"):
        program()  # the eager first call
    before = C.read_counts()
    program.calls = 1
    with pytest.raises(RuntimeError, match="capturing"):
        program()  # the capture
    assert C.read_counts() == before and program.graph is None


# aten ops that read a tensor's value to the host, or make a shape from it
HOST_READS = ("_local_scalar_dense", "is_nonzero", "nonzero", "masked_select", "unique", "_unique", "_unique2",
              "unique_dim", "unique_consecutive", "equal")


# aten ops that take a list of indices, which a boolean mask turns into nonzero's
INDEXING = ("index", "index_put", "index_put_", "_index_put_impl_")


class _NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        masks = name in INDEXING and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8) for i in args[1])
        if name in HOST_READS or masks:
            raise AssertionError(f"the step reads a device value to the host: aten.{name}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Raises on any read of a tensor's value to the host: `.item()`,
    `bool()`, `float()`, shapes made from values (the dispatcher's ops), and
    `.cpu()`, `.numpy()`, `.tolist()` (which a CPU tensor answers without
    the dispatcher)."""
    for name in ("cpu", "numpy", "tolist"):
        def refuse(*args, name=name, **kwargs):
            raise AssertionError(f"the step reads a device value to the host: Tensor.{name}")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with _NoHostReads():
        yield
    monkeypatch.undo()


def test_the_host_read_guard_catches_each_kind_of_read(monkeypatch):
    t = torch.ones(3)
    for read in (lambda: t.sum().item(), lambda: bool(t[0] > 0), lambda: float(t[0]), lambda: t.nonzero(),
                 lambda: t[t > 0], lambda: t.cpu(), lambda: t.numpy(), lambda: t.tolist()):
        with pytest.raises(AssertionError, match="host"):
            with no_host_reads(monkeypatch):
                read()


@pytest.mark.parametrize("option", ["faithful", "skip_nonfinite"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_step_reads_no_device_value_to_the_host(model, option, monkeypatch):
    """One G and one D step of each tiny model, as the trainer runs them
    (float32, the default head), under a guard that raises on any read of a
    tensor's value to the host: what a CUDA graph cannot capture."""
    module, cfg, x_chunk, state0 = _setup(model, 1, dtype=torch.float32, **OPTIONS[option])
    z = torch.zeros((4, cfg["num_latents"]))
    gen_step, discrim_step = TTS.make_train_steps(module, cfg)
    lr = torch.tensor(LR)
    with no_host_reads(monkeypatch):
        state, m_g = gen_step(state0, x_chunk, z, z, lr)
        state, m_d = discrim_step(state, x_chunk, z, z, lr)
    assert all(np.isfinite(float(v)) for m in (m_g, m_d) for v in m.values())


def test_train_keeps_the_first_checkpoints_fid_basis_while_the_state_moves_on(tmp_path):
    """Two epochs in one run with a validation set: epoch 1's encoder-FID is
    the final weights' in epoch 0's feature space, which the trainer keeps as
    a copy (the chunks update the state in place), recomputed here from the
    two files."""
    from npe_tpu_torch.data import SyntheticFaces, data_loader
    from npe_tpu_torch.training.quality import encoder_fid

    TT.train(tp.TINY_TORCH, "synthetic", max_epochs=2, num_examples=16, out_dir=str(tmp_path),
             checkpoint_grids=False, device="cpu", valid_dataset_spec="synthetic", num_valid_examples=12,
             async_checkpoint=True, cfg_overrides={"batch_size": 4, "batches_per_chunk": 2})
    recs = [r for r in map(json.loads, open(tmp_path / "tiny_ianMETRICS.jsonl")) if "validation" in r]
    assert [r["epoch"] for r in recs] == [0, 1]
    tm = get_config(tp.TINY_TORCH)
    final, basis = (tm.init(torch.Generator().manual_seed(0), "cpu") for _ in range(2))
    tckpt.load_weights(str(tmp_path / "tiny_ian.npz"), final)
    assert tckpt.load_weights(str(tmp_path / "tiny_ian_fid_basis.npz"), basis)["epoch"] == 0
    real = next(iter(data_loader(dict(tm.cfg, batch_size=4, batches_per_chunk=3), SyntheticFaces(12), offset=0)))
    want = encoder_fid(tm, final, real, num=12, seed=1, feature_variables=basis)
    np.testing.assert_allclose(recs[1]["validation"]["encoder_fid"], want, rtol=1e-6)
