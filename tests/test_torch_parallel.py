"""npe_tpu_torch's multi-device training on the CPU: two gloo processes
(`init_method="file://..."`, so no TCP port can race) against one process,
and against npe_tpu's sharded step under `make_mesh((8, 1))`.

One pair of worker processes runs every two-rank case once (`dp_run`),
while this process computes the one-process references; the tests read
the results. Tolerances:
  * two ranks vs one process in float64: 1e-7 on losses, metrics, BN
    statistics and parameters; the moments (the gradients: after one step
    mu = (1 - b1) * g) to 1e-7 of each tensor's largest value, plus 1e-12
    for a gradient that is zero in exact arithmetic and comes out as
    rounding noise of about 1e-13 (mu_bnorm.beta: the KL term's gradient
    through a batch norm's shift); frozen weights and masks bit-equal. The
    two sum the batch in other orders, nothing else;
  * the float32 two-rank step vs npe_tpu's GSPMD step: npe_tpu's own
    sharded-vs-unsharded bounds (`tests/test_training_fast.py:119`): metrics
    rtol 2e-3 / atol 2e-4, weights within 2 * lr; the gradients within 10 %
    of each tensor's largest value (`tests/test_torch_training.py`'s float32
    rule: a relu that rounds to the other side moves them by about 1 %);
  * the chunk loop (`make_chunk_step`: each rank's rows of each batch, its
    rows of the global z_rand and noise draws) over two ranks vs one process
    in float64, four steps: metrics to 1e-7; parameters and moments as the
    single steps, except where a gradient is rounding noise (|mu| < 1e-6):
    the shift of mu's batch norm has a gradient of zero in exact arithmetic
    (the decoder's first batch norm removes any shift of z common to the
    batch), and Adam's lr * m / (sqrt(v) + eps) turns noise of either sign
    into steps of up to lr, so there each parameter is held within 4 * lr
    and its moments within 1e-6, and the running means of the layer that
    reads z (bnorm_dec_fc2) move with that shift of mu (2.4e-7 seen), so the
    BN statistics are held within 1e-5;
  * two-rank `train()` in float32 vs one process: metrics at the golden
    tolerance, but discrim_acc, a count of logits above zero, within one of
    the 3 x 4 rows it counts (a logit within rounding of zero at this
    width's init falls either side); trainable weights within 8 * lr after
    each of the two runs (the float32 step rule of
    `tests/test_torch_training.py`). The BN running statistics are held by
    the float64 cases: in float32 the parameters whose gradient is zero in
    exact arithmetic (the shift of a batch norm that another follows) take
    Adam steps of lr * noise / (|noise| + eps) of either sign, and four
    steps move the trajectories' BN means apart by up to 12 %.
"""

import contextlib
import datetime
import functools
import json
import multiprocessing
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parity as tp
from npe_tpu_torch.data import SyntheticFaces
from npe_tpu_torch.data.native_loader import export_raw
from npe_tpu_torch.models import get_config
from npe_tpu_torch.parallel import collectives as C
from npe_tpu_torch.parallel import multihost
from npe_tpu_torch.parallel import mesh as pmesh
from npe_tpu_torch.parallel.mesh import (
    Mesh, gather_train_state, gather_variables, make_mesh, param_spec, shard_batch, shard_layout, shard_train_state,
    shard_variables, state_layout,
)
from npe_tpu_torch.training import train as TT
from npe_tpu_torch.training import train_step as TTS
from npe_tpu_torch.utils import checkpoints as tckpt

tp.torch_threads()

WAIT = 120  # seconds: the longest a worker, or a collective it waits on, may take
LR = 2e-4
CONFIGS = {"IAN_simple": (tp.TINY_JAX, tp.TINY_TORCH), "IANv1": (tp.TINY_V1_JAX, tp.TINY_V1_TORCH),
           "IAN": (tp.TINY_FULL_JAX, tp.TINY_FULL_TORCH)}
TRAIN_KW = dict(config=tp.TINY_TORCH, num_examples=18, checkpoint_grids=False, device="cpu",
                cfg_overrides={"batch_size": 4, "batches_per_chunk": 2})


def _module(model, dtype):
    m = get_config(CONFIGS[model][1])
    return tp.plain_head(m) if dtype == torch.float64 else m


@contextlib.contextmanager
def _tiny_thresholds():
    """The 'model' case's rule: param_spec's at 8 outputs where npe_tpu's
    takes 512 or 4096, so that the tiny profiles hold conv, deconv, MDCL,
    dense and minibatch weights in slices."""
    with mock.patch.object(pmesh, "CONV_MIN", 8), mock.patch.object(pmesh, "DENSE_MIN", 8):
        yield


def _steps(model, inputs, mesh=None, players=("gen", "discrim")):
    """One G step, then one D step (or the `players` named), from `inputs` =
    (variables, x, z, eps) of the global batch; returns (the whole state
    after, {player: metrics})."""
    variables, x, z, eps = inputs
    m = _module(model, x.dtype)
    cfg = dict(m.cfg)
    state = TTS.init_train_state(m, variables, cfg)
    layout = state_layout(state, mesh)
    if mesh is not None:
        state = shard_train_state(state, mesh, layout)
        x, z, eps = (shard_batch(t, mesh) for t in (x, z, eps))
    steps = dict(zip(("gen", "discrim"), TTS.make_train_steps(m, cfg, mesh=mesh, layout=layout)))
    metrics = {}
    for player in players:
        state, m_p = steps[player](state, x, z, eps, LR)
        metrics[player] = {k: float(v) for k, v in m_p.items()}
    return gather_train_state(state, mesh, layout), metrics


def _infer(inputs, mesh=None):
    variables, x, _, _ = inputs
    m = get_config(tp.TINY_TORCH)
    if mesh is not None:
        layout = shard_layout(variables, mesh)
        variables = gather_variables(shard_variables(variables, mesh, layout), mesh, layout)
    with torch.no_grad():
        return m.decode(variables, m.encode(variables, x))


def _train(out_dir, mesh=None):
    """Two chunks of the tiny profile, then a resumed epoch of two more;
    returns (METRICS records, the weights file's arrays after each run) on
    rank 0."""
    weights = []
    for epochs, resume in ((1, False), (2, True)):
        np.random.seed(0)
        TT.train(out_dir=out_dir, max_epochs=epochs, resume=resume, mesh=mesh, **TRAIN_KW)
        if mesh is None or mesh.rank == 0:
            with np.load(os.path.join(out_dir, "tiny_ian.npz")) as f:
                weights.append({k: f[k] for k in f.files if k != tckpt.METADATA_KEY})
    if not weights:
        return None
    with open(os.path.join(out_dir, "tiny_ianMETRICS.jsonl")) as fh:
        return [json.loads(line)["metrics"] for line in fh], weights


def _train_native(out_dir, raw, mesh=None):
    """One epoch of two chunks from a `native:` raw file; rank 0 returns the
    METRICS records."""
    np.random.seed(0)
    TT.train(dataset_spec=f"native:{raw}", out_dir=out_dir, max_epochs=1, mesh=mesh, **TRAIN_KW)
    if mesh is not None and mesh.rank != 0:
        return None
    with open(os.path.join(out_dir, "tiny_ianMETRICS.jsonl")) as fh:
        return [json.loads(line)["metrics"] for line in fh]


def _chunks(inputs, mesh=None):
    """Two chunks of two batches (four rows each) through `make_chunk_step`
    in float64; returns (the whole state, the last chunk's G and D metrics)."""
    variables, x, _, _ = inputs
    m = _module("IAN_simple", torch.float64)
    cfg = dict(m.cfg, batch_size=4)
    state = TTS.init_train_state(m, variables, cfg)
    layout = state_layout(state, mesh)
    chunk = torch.cat([x, x.flip(0)])
    if mesh is not None:
        state = shard_train_state(state, mesh, layout)
        chunk = chunk.reshape(2, mesh.data.size, -1, *chunk.shape[1:])[:, mesh.data.index].flatten(0, 1)
    chunk_step = TTS.make_chunk_step(m, cfg, 2, mesh=mesh, layout=layout)
    gen = torch.Generator().manual_seed(5)
    for itr in (0, 2):
        state, m_g, m_d, _ = chunk_step(state, chunk, itr, gen, LR)
    return gather_train_state(state, mesh, layout), {"gen": {k: float(v) for k, v in m_g.items()},
                                             "discrim": {k: float(v) for k, v in m_d.items()}}


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def _worker(rank, store, inputs_path, out_path, train_dir, raw):
    """One of two ranks: every two-rank case, its results saved for the test."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=WAIT))
    out = {}
    try:
        inputs = torch.load(inputs_path)
        cpus = ["cpu", "cpu"]
        out["bad_shape"] = _raises(lambda: make_mesh((2, 2), devices=cpus))
        mesh = make_mesh(devices=cpus)
        out["shape"] = mesh.shape
        for model in CONFIGS:
            out["f64", model] = _steps(model, inputs["f64", model], mesh)
        out["f32"] = _steps("IAN_simple", inputs["f32"], mesh, players=("gen",))
        out["chunk"] = _chunks(inputs["f64", "IAN_simple"], mesh)
        tensor_mesh = make_mesh((1, 2), devices=cpus)
        with _tiny_thresholds():
            out["tensor_infer"] = _infer(inputs["f64", "IAN_simple"], tensor_mesh)
            out["tensor_steps"] = _steps("IAN", inputs["f64", "IAN"], tensor_mesh)
            out["tensor_layout"] = shard_layout(inputs["f64", "IAN"][0], tensor_mesh)
        out["demo"] = multihost.run_demo(mesh, 4, tp.TINY_TORCH, seed=3)
        out["train"] = _train(train_dir, mesh)  # one directory, as under torchrun
        out["native"] = _train_native(train_dir + "_native", raw, mesh)
    finally:
        torch.save(out, f"{out_path}.{rank}")
        dist.destroy_process_group()


def _f64_inputs(model):
    variables = tckpt.from_reference({k: np.asarray(v, np.float64) for k, v in
                                      tp.jax_variables(CONFIGS[model][0]).items()}, "cpu")
    rng = np.random.RandomState(7)
    zdim = get_config(CONFIGS[model][1]).cfg["num_latents"]
    x = rng.uniform(-1, 1, (4, 3, 64, 64))
    return (variables, *(torch.from_numpy(a) for a in (x, rng.randn(4, zdim), rng.randn(4, zdim))))


@functools.cache
def _f32_case():
    """test_training_fast.py:119's inputs at batch 8, the tiny profile's
    unit-gain weights, and npe_tpu's G step on them: unsharded, and under
    make_mesh((8, 1)) (conftest's eight virtual CPU devices)."""
    import jax

    from npe_tpu.models import get_config as jax_config
    from npe_tpu.parallel.mesh import make_mesh as jax_mesh
    from npe_tpu.parallel.mesh import shard_batch as jax_batch
    from npe_tpu.parallel.mesh import shard_train_state as jax_shard
    from npe_tpu.training import train_step as JTS

    jm = jax_config(tp.TINY_JAX)
    cfg = dict(jm.cfg)
    v = tp.as_jax(tp.jax_variables(tp.TINY_JAX))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 64, 64, 3)) * 0.5
    z = jax.random.normal(jax.random.PRNGKey(2), (8, cfg["num_latents"]))
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, z.shape))
    gen_step, _ = JTS.make_train_steps(jm, cfg, donate=False)
    mesh = jax_mesh(shape=(8, 1))
    state, metrics = gen_step(jax_shard(JTS.init_train_state(jm, v, cfg), mesh), jax_batch(x, mesh),
                              jax_batch(z, mesh), key, LR)
    inputs = (tp.port_variables(tp.TINY_JAX), tp.nchw(np.asarray(x)), torch.from_numpy(np.array(z)),
              torch.from_numpy(eps))
    return inputs, jax.tree_util.tree_map(np.asarray, state), {k: float(val) for k, val in metrics.items()}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Both ranks' results ("ranks") beside this process's references."""
    tmp = tmp_path_factory.mktemp("dp")
    inputs = {("f64", m): _f64_inputs(m) for m in CONFIGS}
    f32_inputs, jax_state, jax_metrics = _f32_case()
    inputs["f32"] = f32_inputs
    torch.save(inputs, tmp / "inputs.pt")
    raw = str(tmp / "faces.raw")
    export_raw(SyntheticFaces(TRAIN_KW["num_examples"]), raw)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp / "store"), str(tmp / "inputs.pt"), str(tmp / "out"),
                                               str(tmp / "ranks"), raw)) for r in range(2)]
    for p in procs:
        p.start()
    ref = {("f64", m): _steps(m, inputs["f64", m]) for m in CONFIGS}
    ref["infer"] = _infer(inputs["f64", "IAN_simple"])
    ref["chunk"] = _chunks(inputs["f64", "IAN_simple"])
    ref["demo"] = multihost.run_demo(None, 4, tp.TINY_TORCH, seed=3, device="cpu")
    ref["train"] = _train(str(tmp / "single"))
    ref["native"] = _train_native(str(tmp / "single_native"), raw)
    for p in procs:
        p.join(timeout=WAIT)
        alive = p.is_alive()
        if alive:
            p.kill()
        assert not alive and p.exitcode == 0, f"worker ended with {p.exitcode}"
    ranks = [torch.load(f"{tmp}/out.{r}", weights_only=False) for r in range(2)]
    return {"ref": ref, "ranks": ranks, "jax_state": jax_state, "jax_metrics": jax_metrics}


def _assert_states_close(got, want, tol=1e-7, moments_floor=1e-12, steps=2, noise_steps=None):
    """`noise_steps`: where the final mu is below 1e-6 (a gradient of rounding
    noise), a parameter within noise_steps * lr and its moments within 1e-6."""
    mu = {k: w for opt in want["opt"].values() for k, w in opt["mu"].items()}
    for part, variables in want["parts"].items():
        for k, w in variables.items():
            g = got["parts"][part][k]
            if part == "frozen" or k.endswith(".weights_mask"):
                assert torch.equal(g, w), k
                continue
            noise = mu[k].abs() < 1e-6 if noise_steps and k in mu else torch.zeros_like(w, dtype=torch.bool)
            atol = 1e-5 if noise_steps and part == "state" else tol
            np.testing.assert_allclose(g[~noise], w[~noise], rtol=tol, atol=atol, err_msg=f"{part}/{k}")
            if noise.any():
                np.testing.assert_allclose(g[noise], w[noise], rtol=0, atol=noise_steps * LR, err_msg=f"{part}/{k}")
    for part, opt in want["opt"].items():
        assert int(got["opt"][part]["count"]) == int(opt["count"])
        for field in ("mu", "nu"):
            for k, w in opt[field].items():
                g = got["opt"][part][field][k]
                noise = mu[k].abs() < 1e-6 if noise_steps else torch.zeros_like(w, dtype=torch.bool)
                np.testing.assert_allclose(g[~noise], w[~noise], rtol=tol, atol=tol * float(w.abs().max()) + moments_floor,
                                           err_msg=f"{part}/{field}/{k}")
                np.testing.assert_allclose(g[noise], w[noise], rtol=0, atol=1e-6, err_msg=f"{part}/{field}/{k}")
    assert int(got["step"]) == int(want["step"]) == steps


def _assert_metrics_close(got, want, rtol, atol, acc_atol=None):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        a = acc_atol if k == "discrim_acc" and acc_atol is not None else atol
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=a, err_msg=k)


# --- the mesh and its rules, in this process ---------------------------------


def test_param_spec_rules_in_the_port_layouts():
    """npe_tpu's rule (tests/test_parallel.py:18) on the port's layouts:
    conv and MDCL kernels (cout, cin, kh, kw) shard axis 0, deconv kernels
    (cin, cout, kh, kw) axis 1, wide dense outputs and the minibatch kernels
    axis 1."""
    z = torch.zeros
    assert param_spec("enc_conv4.W", z(1024, 512, 5, 5)) == ("model", None, None, None)
    assert param_spec("enc_conv1.W", z(128, 3, 5, 5)) == ()
    assert param_spec("dec_conv1.W", z(1024, 512, 5, 5)) == (None, "model", None, None)
    assert param_spec("dec_conv3.W", z(256, 128, 5, 5)) == ()
    assert param_spec("dec_conv2aW", z(512, 512, 3, 3)) == ("model", None, None, None)
    assert param_spec("dec_conv2a_coeff_base", z(512)) == ()
    assert param_spec("l_dec_fc2.W", z(100, 16384)) == (None, "model")
    assert param_spec("enc_fc1.W", z(16384, 1000)) == ()
    assert param_spec("minibatch_discrim.theta", z(1024, 500, 5)) == (None, "model", None)
    assert param_spec("bnorm2.beta", z(256)) == ()


def test_a_mesh_without_a_process_group_is_a_world_of_one():
    assert not dist.is_initialized()
    mesh = make_mesh(devices=["cpu"])
    assert mesh.shape == (1, 1) and mesh.data.size == mesh.model.size == 1 and mesh.rank == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((2, 1), devices=["cpu"])
    with pytest.raises(ValueError, match="one device per rank"):
        make_mesh(devices=["cpu", "cpu"])
    v = tp.port_variables(tp.TINY_JAX)
    with _tiny_thresholds():
        assert shard_layout(v, mesh) == {}
    assert all(a is b for a, b in zip(shard_variables(v, mesh, {}).values(), v.values()))


def test_the_layout_is_a_pure_function_of_names_shapes_and_the_rule():
    """shard_layout reads no state of the mesh: two rules on one mesh give
    two layouts, each the same on every call; shard_variables follows the
    layout it is given."""
    mesh = Mesh((1, 2), 0, torch.device("cpu"), C.Axis("data", None, 1, 0), C.Axis("model", None, 2, 0))
    v = tp.port_variables(tp.TINY_JAX)
    npe = {"minibatch_discrim.theta": 1}  # the tiny widths are below npe_tpu's thresholds, theta has none
    assert shard_layout(v, mesh) == npe
    with _tiny_thresholds():
        tiny = shard_layout(v, mesh)
        assert len(tiny) > 1 and tiny == shard_layout(v, mesh)
    assert shard_layout(v, mesh) == npe
    assert tiny["enc_conv4.W"] == 0 and tiny["dec_conv1.W"] == 1
    shards = shard_variables(v, mesh, tiny)
    for k, t in v.items():
        want = t.chunk(2, tiny[k])[0] if k in tiny else t
        assert torch.equal(shards[k], want), k
    with _tiny_thresholds(), pytest.raises(ValueError, match="equal slices"):
        shard_layout({"enc_conv9.W": torch.zeros(9, 4, 3, 3)}, mesh)


def test_without_an_axis_the_collective_helpers_are_one_device():
    t = torch.arange(6.0).reshape(2, 3)
    assert C.current_data_axis() is None
    assert C.batch_mean(t) == t.mean() and C.once(t) is t and C.all_gather_rows(t, None) is t
    m = {"a": t.sum()}
    assert C.sum_metrics(m) is m
    with C.data_axis(C.Axis("data", None, 1, 0)):  # an axis of one is no axis
        assert C.current_data_axis() is None
    with C.data_axis(C.Axis("data", None, 2, 1)):  # a second rank's share, without a collective
        assert C.batch_mean(t) == t.sum() / 12 and float(C.once(t).abs().sum()) == 0
    assert C.current_data_axis() is None


def test_a_world_of_one_step_is_the_plain_step():
    inputs = _f64_inputs("IAN_simple")
    state, metrics = _steps("IAN_simple", inputs, make_mesh(devices=["cpu"]))
    want_state, want_metrics = _steps("IAN_simple", inputs)
    assert metrics == want_metrics
    for part, variables in want_state["parts"].items():
        for k, w in variables.items():
            assert torch.equal(state["parts"][part][k], w), k


# --- two ranks ----------------------------------------------------------------


def test_a_mesh_shape_that_does_not_match_the_world_raises(dp_run):
    assert all(r["bad_shape"] for r in dp_run["ranks"])
    assert all(r["shape"] == (2, 1) for r in dp_run["ranks"])


@pytest.mark.parametrize("model", list(CONFIGS))
def test_two_rank_step_equals_one_process_in_float64(dp_run, model):
    """A G step then a D step over two ranks (two rows each) against one
    process on the four rows: losses and metrics, BN running statistics,
    parameters, moments and counts; frozen MADE weights and masks bit-equal."""
    want_state, want_metrics = dp_run["ref"]["f64", model]
    for rank in dp_run["ranks"]:
        state, metrics = rank["f64", model]
        for player in ("gen", "discrim"):
            _assert_metrics_close(metrics[player], want_metrics[player], 1e-7, 1e-7)
        _assert_states_close(state, want_state)
    if model == "IAN":
        assert want_state["parts"]["frozen"]


def test_two_ranks_hold_the_same_replicas(dp_run):
    a, b = dp_run["ranks"]
    for key in [("f64", m) for m in CONFIGS] + ["f32"]:
        for part, variables in a[key][0]["parts"].items():
            for k, t in variables.items():
                assert torch.equal(t, b[key][0]["parts"][part][k]), (key, part, k)
        assert a[key][1] == b[key][1]


def test_two_rank_float32_step_matches_npe_tpu_sharded_step(dp_run):
    """The port's float32 G step over two ranks (four rows each) against
    npe_tpu's gen_step under make_mesh((8, 1)) on the same inputs and
    weights."""
    jax_state, jax_metrics = dp_run["jax_state"], dp_run["jax_metrics"]
    state, metrics = dp_run["ranks"][0]["f32"]
    _assert_metrics_close(metrics["gen"], jax_metrics, 2e-3, 2e-4)
    for part in ("gen", "latent"):
        got = tckpt.to_reference(state["parts"][part])
        for k, want in jax_state["parts"][part].items():
            np.testing.assert_allclose(got[k], want, rtol=1e-2, atol=2 * LR + 1e-6, err_msg=f"{part}/{k}")
        tp.assert_grads_close(tckpt.to_reference(state["opt"][part]["mu"]), jax_state["opt"][part].mu,
                              rtol=0, atol_of_largest=1e-1, floor=1e-6)
    for k, want in jax_state["parts"]["state"].items():
        tp.assert_close(state["parts"]["state"][k].numpy(), want)


def test_model_axis_holds_slices_and_equals_one_process(dp_run):
    """Mesh (1, 2): the weights the rule names are held in halves, and
    encode + decode and a G + D step of full IAN equal one process's."""
    for rank in dp_run["ranks"]:
        layout = rank["tensor_layout"]
        assert {"enc_conv4.W", "dec_conv1.W", "l_dec_fc2.W", "minibatch_discrim.theta"} <= set(layout), layout
        assert any(k.endswith("aW") for k in layout) and layout["dec_conv1.W"] == 1
        np.testing.assert_allclose(rank["tensor_infer"], dp_run["ref"]["infer"], rtol=1e-12, atol=1e-12)
        state, metrics = rank["tensor_steps"]
        want_state, want_metrics = dp_run["ref"]["f64", "IAN"]
        assert metrics == want_metrics
        _assert_states_close(state, want_state, tol=1e-12)


def test_demo_step_matches_one_process(dp_run):
    """multihost.run_demo: each rank stages its rows of the seeded global
    batch; the metrics are one process's, on both ranks, the two ranks end
    with the same state bit for bit (its digest), and the Adam first
    moments, the summed gradients' trace, are one process's within the
    float32 gradient rule (10 % of each tensor's largest value: a gradient
    summed once too few or too many times is off by 50 % or 100 %), plus
    1e-4 of the part's largest for a gradient that is zero in exact
    arithmetic and comes out as rounding noise (mu_bnorm.beta's, 1.4e-6 of
    the part's largest seen; the other tensors agree to 1.3e-5 of their
    own largest)."""
    want = dp_run["ref"]["demo"]
    a, b = (rank["demo"] for rank in dp_run["ranks"])
    assert a["state_sha256"] == b["state_sha256"]
    for got in (a, b):
        for player in ("gen", "discrim"):
            _assert_metrics_close(got[player], want[player], 1e-4, 1e-5)
        assert got["launches"] == {"staging": 0, "rgb_beta_tail": 0}  # CPU tensors: the plain versions
        assert sorted(got["mu"]) == sorted(want["mu"]) == ["discrim", "gen", "latent"]
        for part, mu in want["mu"].items():
            largest = max(float(t.abs().max()) for t in mu.values())
            tp.assert_grads_close(got["mu"][part], mu, rtol=0, atol_of_largest=1e-1, floor=1e-4 * largest)


def test_train_over_two_ranks_writes_the_one_process_run(dp_run):
    """train(mesh=...) for two chunks, then --resume for two more, against
    one process on the same chunks and permutations (np.random seeded
    alike): the same METRICS records and checkpoint, rank 0 writing."""
    got, ref = dp_run["ranks"][0]["train"], dp_run["ref"]["train"]
    assert dp_run["ranks"][1]["train"] is None
    (got_m, got_w), (want_m, want_w) = got, ref
    assert len(got_m) == len(want_m) == 4
    for g, w in zip(got_m, want_m):
        _assert_metrics_close(g, w, tp.RTOL, tp.ATOL, acc_atol=1 / 12 + 1e-6)
    for got_run, want_run in zip(got_w, want_w):
        assert sorted(got_run) == sorted(want_run)
        for k, w in want_run.items():
            assert np.isfinite(got_run[k]).all(), k
            if not k.endswith((".mean", ".inv_std")):
                np.testing.assert_allclose(got_run[k], w, rtol=0, atol=8 * LR, err_msg=k)


def test_two_rank_chunk_loop_equals_one_process_in_float64(dp_run):
    want_state, want_metrics = dp_run["ref"]["chunk"]
    for rank in dp_run["ranks"]:
        state, metrics = rank["chunk"]
        for which in ("gen", "discrim"):
            _assert_metrics_close(metrics[which], want_metrics[which], 1e-7, 1e-7)
        _assert_states_close(state, want_state, steps=4, noise_steps=4)


def test_train_over_two_ranks_from_a_native_file_writes_the_one_process_run(dp_run):
    got, want = dp_run["ranks"][0]["native"], dp_run["ref"]["native"]
    assert dp_run["ranks"][1]["native"] is None and len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_metrics_close(g, w, tp.RTOL, tp.ATOL, acc_atol=1 / 12 + 1e-6)


def test_trainer_cli_data_parallel_alone_is_a_world_of_one(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    TT.main([tp.TINY_TORCH, "--data-parallel", "--device", "cpu", "--batch-size", "4", "--batches-per-chunk", "2",
             "--num-examples", "10", "--max-epochs", "1", "--out-dir", str(tmp_path),
             "--pics-dir", str(tmp_path / "pics")])
    assert not dist.is_initialized()
    with open(tmp_path / "tiny_ianMETRICS.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    assert len(records) == 1 and all(np.isfinite(v) for v in records[0]["metrics"].values())
    assert (tmp_path / "tiny_ian.npz").is_file() and (tmp_path / "tiny_ian_train_state.npz").is_file()
