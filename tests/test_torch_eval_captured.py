"""The training side's sampling and evaluation programs
(`npe_tpu_torch/training/programs.py`: `sample.py`'s four functions, the
checkpoint grid's decode and encode, `recon_mse` and the encoder-FID's
features and samples) on the CPU, where every signature's body runs directly
on its buffers: each program against npe_tpu's jitted function on the same
weights and inputs, loads (a second set of weights reaches every program; a
load refuses another structure), the capture bookkeeping through a stand-in
graph whose replay runs the captured body, a guard that no body reads a
device value to the host, `ProgramCache`'s tensor inputs and device outputs,
and `train()`, whose checkpoints capture no new signature after the first
and whose encoder-FID basis does not follow the training.

The cases marked `cuda` need the card and skip here. The module imports no
JAX at the top (the npe_tpu side comes through the `jax_side` fixture), so
that on a machine without JAX they run with

    python -m pytest --noconftest -m cuda tests/test_torch_eval_captured.py -q
"""

import contextlib
import json
import pathlib

import numpy as np
import pytest
import torch

from npe_tpu_torch.models import get_config
from npe_tpu_torch.training import train as TT
from npe_tpu_torch.training.programs import PROGRAMS, EvalPrograms
from npe_tpu_torch.training.sample import make_inference_functions
from npe_tpu_torch.utils import checkpoints, graphs
from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain

HERE = pathlib.Path(__file__).resolve().parent
TINY = {"IAN_simple": (str(HERE / "tiny_ian_torch.py"), "tests/tiny_ian.py"),
        "IANv1": (str(HERE / "tiny_ianv1_torch.py"), "tests/tiny_ianv1.py"),
        "IAN": (str(HERE / "tiny_ian_full_torch.py"), "tests/tiny_ian_full.py")}
ZDIM = 16  # the tiny profiles' latents
torch.set_num_threads(1)  # torch_parity.torch_threads' rule: one intra-op thread a test worker


@pytest.fixture(scope="module")
def jax_side():
    """torch_parity, imported here so that the module itself imports no JAX."""
    import torch_parity

    return torch_parity


def _inputs(seed, n=3):
    """Images in [-1, 1] (NCHW) and latents, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (n, 3, 64, 64)).astype(np.float32), rng.randn(n, ZDIM).astype(np.float32)


def _reference_variables(model, seed):
    """Seeded unit-gain weights (the tests' and chip_smoke.py's rule) in
    npe_tpu's layout, numpy."""
    seeded = get_config(TINY[model][0]).init(torch.Generator().manual_seed(seed), "cpu")
    return unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1)


def _variables(model, seed, device="cpu"):
    return from_reference(_reference_variables(model, seed), device)


def _run_all(owner, x, z):
    """Every program of `owner` on images x and latents z, as numpy."""
    return {name: owner(name, x if name in ("encode_pre_iaf", "recon_mse", "features") else z).cpu().numpy()
            for name in PROGRAMS}


# --- against npe_tpu ------------------------------------------------------------


@pytest.fixture(scope="module")
def npe_tpu_programs(jax_side):
    """{model: (npe_tpu variables, {program: npe_tpu's jitted result})} on the
    inputs of `_inputs(1)`: sample.py's four jitted functions, quality.py's
    jitted features (`batched_features`) and evaluate.py's recon_mse body
    under jax.jit. The variables, the port's seeded weights in npe_tpu's
    layout (npe_tpu's own eager init takes 10 s a tiny model), have their BN
    state moved off the identity."""
    import jax
    import jax.numpy as jnp
    from npe_tpu.models import get_config as jax_config
    from npe_tpu.training.quality import batched_features
    from npe_tpu.training.sample import make_inference_functions as jax_functions

    tp = jax_side
    x, z = _inputs(1)
    x_nhwc = x.transpose(0, 2, 3, 1)
    out = {}
    for model, (_, jax_path) in TINY.items():
        jm = jax_config(jax_path)
        jv = tp.with_bn_state(_reference_variables(model, 4), seed=3)
        v = tp.as_jax(jv)
        fns = jax_functions(jm)
        recon_mse = jax.jit(lambda v, x, jm=jm: jnp.mean((jm.decode(v, jm.encode(v, x)) - x) ** 2))
        want = {"decode_pre_iaf": fns["sample"](v, z), "decode": fns["sampleZ"](v, z),
                "encode_pre_iaf": fns["Zfn"](v, x_nhwc), "iaf": fns["Z_IAF_fn"](v, z),
                "recon_mse": recon_mse(v, x_nhwc), "features": batched_features(jm, v, x_nhwc, len(x))}
        want = {k: np.asarray(w) for k, w in want.items()}
        for k in ("decode_pre_iaf", "decode"):
            want[k] = want[k].transpose(0, 3, 1, 2)  # NHWC -> the port's NCHW
        out[model] = jv, want
    return out


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("model", sorted(TINY))
def test_each_program_matches_npe_tpus_jitted_function(jax_side, npe_tpu_programs, model, program):
    """One owner's program against npe_tpu's jitted counterpart on the same
    weights (BN state off the identity) and inputs, at the golden tolerance."""
    jv, want = npe_tpu_programs[model]
    owner = EvalPrograms.of(get_config(TINY[model][0]), from_reference(jv, "cpu"))
    got = _run_all(owner, *(torch.from_numpy(a) for a in _inputs(1)))[program]
    assert got.shape == want[program].shape and got.dtype == np.float32
    jax_side.assert_close(got, want[program])
    assert np.abs(got).max() > 1e-4  # not a vacuous match


@pytest.mark.parametrize("model", sorted(TINY))
def test_the_inference_functions_match_npe_tpus(jax_side, npe_tpu_programs, model):
    """`make_inference_functions`' four functions, one owner behind them,
    against npe_tpu's on the same weights: a tensor in, a tensor on the
    variables' device out."""
    jv, want = npe_tpu_programs[model]
    fns = make_inference_functions(get_config(TINY[model][0]))
    v = from_reference(jv, "cpu")
    x, z = (torch.from_numpy(a) for a in _inputs(1))
    for name, program, arg in (("sample", "decode_pre_iaf", z), ("sampleZ", "decode", z),
                               ("Zfn", "encode_pre_iaf", x), ("Z_IAF_fn", "iaf", z)):
        got = fns[name](v, arg)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu" and not got.requires_grad
        jax_side.assert_close(got.numpy(), want[program])


# --- loads ----------------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(TINY))
def test_a_program_computes_with_the_weights_loaded_last(model):
    """A second load reaches every program, whose results are then a fresh
    owner's on the second weights; changing the tensors of a load in place
    changes nothing until they are loaded again (the programs read their
    own buffers, never the caller's tensors)."""
    tm = get_config(TINY[model][0])
    va, vb = _variables(model, 0), _variables(model, 1)
    x, z = (torch.from_numpy(a) for a in _inputs(2))
    owner = EvalPrograms.of(tm, va)
    first = _run_all(owner, x, z)
    owner.load(vb)
    second = _run_all(owner, x, z)
    fresh = _run_all(EvalPrograms.of(tm, vb), x, z)
    for name in PROGRAMS:
        np.testing.assert_array_equal(second[name], fresh[name])
        if name != "iaf" or model != "IAN_simple":  # IAN_simple's flow is the identity
            assert not np.array_equal(second[name], first[name]), name
    with torch.no_grad():
        for t in vb.values():
            t.add_(0.01)
    np.testing.assert_array_equal(owner("decode", z).numpy(), second["decode"])
    owner.load(vb)
    assert not np.array_equal(owner("decode", z).numpy(), second["decode"])
    assert len(owner.programs.signatures) == len(PROGRAMS)  # loads make no signature


@pytest.mark.parametrize("model", ["IAN_simple", "IAN"])
def test_the_inference_functions_load_the_variables_of_each_call(model):
    """Each call of a `make_inference_functions` function loads the
    variables it is given: calls on two sets of weights in turn give each
    set's results, bit for bit those of the module's own functions."""
    tm = get_config(TINY[model][0])
    fns = make_inference_functions(tm)
    z = torch.from_numpy(_inputs(3)[1])
    for seed in (0, 1, 0):
        v = _variables(model, seed)
        assert torch.equal(fns["sample"](v, z), tm.decode_pre_iaf(v, z))
        assert torch.equal(fns["sampleZ"](v, z), tm.decode(v, z))


def _other_structure(v, kind):
    v = dict(v)
    name = sorted(v)[0]
    if kind == "a name missing":
        del v[name]
    elif kind == "a name added":
        v["extra.W"] = torch.zeros(3)
    elif kind == "another shape":
        v[name] = torch.zeros(tuple(v[name].shape) + (1,))
    elif kind == "another dtype":
        v[name] = v[name].double()
    else:  # another device
        v[name] = torch.empty(v[name].shape, device="meta")
    return v


@pytest.mark.parametrize("kind", ["a name missing", "a name added", "another shape", "another dtype",
                                  "another device"])
def test_load_refuses_another_structure(kind):
    tm = get_config(TINY["IANv1"][0])
    v = _variables("IANv1", 0)
    owner = EvalPrograms.of(tm, v)
    z = torch.from_numpy(_inputs(4)[1])
    want = owner("decode", z)
    with pytest.raises(ValueError):
        owner.load(_other_structure(v, kind))
    assert torch.equal(owner("decode", z), want)  # the buffers are as they were
    if kind in ("another dtype", "another device"):  # a first load takes any names and shapes, not these
        with pytest.raises(ValueError):
            EvalPrograms(tm, "cpu").load(_other_structure(v, kind))


def test_a_program_before_any_load_raises():
    with pytest.raises(RuntimeError, match="load"):
        EvalPrograms(get_config(TINY["IAN_simple"][0]), "cpu")("decode", np.zeros((1, ZDIM), np.float32))


# --- the capture bookkeeping, through a stand-in graph ------------------------------


class _ReplayingGraph:
    """A stand-in for a captured CUDA graph: its replay runs the captured body
    again, on the buffers as they are, as the card's replay runs its kernels
    on the memory they were captured on."""

    def __init__(self, body):
        self.body, self.replays = body, 0

    def replay(self):
        self.replays += 1
        self.body()


@contextlib.contextmanager
def _stand_in_graphs(monkeypatch, owner):
    captured = []

    def capture(body, stream, pool):
        captured.append(_ReplayingGraph(body))
        return captured[-1], [0] * len(graphs.COUNTERS)

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "_on", lambda stream: contextlib.nullcontext())
    owner.programs.stream = object()  # as on the card
    yield captured


@pytest.mark.parametrize("model", sorted(TINY))
def test_one_capture_a_signature_across_loads_and_replays_that_follow_the_buffers(model, monkeypatch):
    """Every program at two shapes (the grid's 27 and 6 rows stand for its
    signatures), on two sets of weights in turn and new inputs each time:
    each signature's first call runs eagerly and captures, every later call
    replays; each result equals an eager owner's on the same weights and
    inputs, so a replay sees the weights loaded last and the inputs of its
    own call, never those of its capture."""
    tm = get_config(TINY[model][0])
    weights = [_variables(model, s) for s in (0, 1)]
    owner = EvalPrograms(tm, "cpu")
    eager = EvalPrograms(tm, "cpu")
    with _stand_in_graphs(monkeypatch, owner) as captured:
        for step in range(4):
            owner.load(weights[step % 2])
            eager.load(weights[step % 2])
            for n in (2, 3):
                x, z = (torch.from_numpy(a) for a in _inputs(10 * step + n, n))
                got, want = _run_all(owner, x, z), _run_all(eager, x, z)
                for name in PROGRAMS:
                    np.testing.assert_array_equal(got[name], want[name], err_msg=f"call {step}, {name} at {n}")
    assert owner.programs.captures() == {key: 1 for key in owner.programs.signatures}
    assert len(owner.programs.signatures) == 2 * len(PROGRAMS) == len(captured) == owner.programs.first_calls
    assert all(g.replays == 3 for g in captured)  # the four loads' calls: one eager, three replays


@pytest.mark.parametrize("model", sorted(TINY))
def test_no_program_body_reads_a_device_value_to_the_host(model):
    """Each body on tensors, under a guard that raises on any read of a
    tensor's value to the host: what a CUDA graph cannot take."""
    from test_torch_captured import no_host_reads

    owner = EvalPrograms.of(get_config(TINY[model][0]), _variables(model, 0))
    x, z = (torch.from_numpy(a) for a in _inputs(5))
    with pytest.MonkeyPatch.context() as mp, no_host_reads(mp):
        outs = [getattr(owner, "_" + name)(x if name in ("encode_pre_iaf", "recon_mse", "features") else z)
                for name in PROGRAMS]
    assert all(torch.isfinite(o).all() for o in outs)


# --- ProgramCache: tensors in, tensors out ------------------------------------------


class _Holder:
    def __init__(self):
        self.programs = graphs.ProgramCache("cpu")
        self.programs.define("f", self.f)
        self.programs.define("g", self.g)

    def f(self, x):
        return x * 2, x.sum()

    def g(self, x):
        return x * 2


def test_tensors_on_the_caches_device_go_in_as_they_are_and_outputs_can_stay_there():
    """A tensor on the cache's device is copied into its buffer on the device
    (a CPU tensor is the host's array for a cache on the card; one on another
    device raises), with the padding rule of host arrays; `download=False`
    gives new tensors on the device, which later calls leave alone, and a 0-d
    output comes back 0-d."""
    holder = _Holder()
    cache = holder.programs
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_(True)
    doubled, total = cache("f", x, download=False)
    assert isinstance(doubled, torch.Tensor) and doubled.shape == (2, 3) and total.shape == ()
    assert torch.equal(doubled, x.detach() * 2) and float(total) == 15 and not doubled.requires_grad
    cache("f", -x, download=False)
    assert torch.equal(doubled, x.detach() * 2)  # an output of its own
    host = cache("f", x.detach().numpy())
    assert isinstance(host[0], np.ndarray) and len(cache.signatures) == 1  # tensor or array: one signature
    padded = cache("g", x[:1], pad_to=4, download=False)
    assert padded.shape == (1, 3) and torch.equal(padded, x.detach()[:1] * 2)
    (sig,) = [s for key, s in cache.signatures.items() if key[1][0][0] == (4, 3)]
    assert torch.equal(sig.inputs[0][1:], torch.zeros(3, 3))
    with pytest.raises(TypeError, match="meta"):
        cache("f", torch.zeros(2, 3, device="meta"))


# --- train() -----------------------------------------------------------------------


def test_train_captures_no_new_signature_after_the_first_checkpoint_and_keeps_its_fid_basis(tmp_path,
                                                                                               monkeypatch):
    """Three epochs on the CPU with grids and a validation set: the trainer
    makes two owners, the current weights' (loaded once a checkpoint) and the
    FID basis' (loaded once); every signature is made at the first
    checkpoint and none after; after the later chunks the basis' buffers still
    equal the saved basis file bit for bit, and differ from the final
    weights."""
    owners = []

    class Recorded(EvalPrograms):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.signatures_at_load = []
            owners.append(self)

        def load(self, variables):
            self.signatures_at_load.append(self.programs.first_calls)
            super().load(variables)

    monkeypatch.setattr(TT, "EvalPrograms", Recorded)
    TT.train(TINY["IAN_simple"][0], "synthetic", max_epochs=3, num_examples=16, out_dir=str(tmp_path),
             pics_dir=str(tmp_path / "pics"), device="cpu", valid_dataset_spec="synthetic", num_valid_examples=12,
             async_checkpoint=True, cfg_overrides={"batch_size": 4, "batches_per_chunk": 2})
    current, basis = owners
    made = current.signatures_at_load + [current.programs.first_calls]
    assert made[0] == 0 and made[1] > 0 and made[1:] == [made[1]] * 3, made
    keys = sorted((key[0], key[1][0][0][0]) for key in current.programs.signatures)
    # the grid's 27 and 21 samples and its 6 endpoints; validation's batches
    # of 4; the FID's 12 samples (IAN_simple's sample path is the decode),
    # whose features and the 12 real images' run on the basis
    assert keys == [("decode", 12), ("decode_pre_iaf", 21), ("decode_pre_iaf", 27), ("encode_pre_iaf", 6),
                    ("recon_mse", 4)], keys
    assert basis.signatures_at_load == [0] and list(basis.programs.signatures) == [
        ("features", (((12, 3, 64, 64), torch.float32),))]
    tm = get_config(TINY["IAN_simple"][0])
    saved, final = (tm.init(torch.Generator().manual_seed(0), "cpu") for _ in range(2))
    assert checkpoints.load_weights(str(tmp_path / "tiny_ian_fid_basis.npz"), saved)["epoch"] == 0
    checkpoints.load_weights(str(tmp_path / "tiny_ian.npz"), final)
    assert all(torch.equal(basis.variables[k], saved[k]) for k in saved)
    assert any(not torch.equal(basis.variables[k], final[k]) for k in final)
    recs = [r for r in map(json.loads, open(tmp_path / "tiny_ianMETRICS.jsonl")) if "validation" in r]
    assert [r["epoch"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["validation"]["encoder_fid"]) for r in recs)
    assert all((tmp_path / "pics" / f"tiny_ian_{e}.png").is_file() for e in range(3))


# --- on the card -------------------------------------------------------------------


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


@pytest.mark.cuda
@pytest.mark.parametrize("model", sorted(TINY))
def test_the_captured_programs_equal_eager_on_the_card(cuda, model):
    """Every program captured and eager on the tiny profiles under
    deterministic algorithms: equal bit for bit at the capture's call, on new
    inputs, and after a second load; one capture a signature."""
    tm = get_config(TINY[model][0])
    weights = [_variables(model, s, cuda) for s in (0, 1)]
    with _deterministic():
        owners = [EvalPrograms(tm, cuda, eager=e) for e in (False, True)]
        for step, seed in enumerate((0, 1, 2)):
            x, z = (torch.from_numpy(a).to(cuda) for a in _inputs(20 + seed))
            for owner in owners:
                owner.load(weights[min(step, 1)])
            got, want = (_run_all(owner, x, z) for owner in owners)
            for name in PROGRAMS:
                np.testing.assert_array_equal(got[name], want[name], err_msg=f"call {step}, {name}")
    assert list(owners[0].programs.captures().values()) == [1] * len(PROGRAMS)
    assert not any(owners[1].programs.captures().values())
