"""The port's inference entry points as programs (`npe_tpu_torch/utils/graphs.ProgramCache`)
on the CPU, where every signature's body runs directly on its buffers: the
cache's keys, staging, padding and bookkeeping (the capture through a
stand-in for the CUDA graph), a guard that no body of `api.IAN` or the
server reads a device value to the host, `api.IAN`'s four methods against
npe_tpu's with a brush that moves, resizes and changes colour, and the
editor's load, sample and decode through the runner's encode and decode
programs against npe_tpu's session. Served rows against npe_tpu's padded
server are in tests/test_torch_serving.py.

The cases marked `cuda` need the card and skip here. The module imports no
JAX at the top (the npe_tpu side comes through the `jax_side` fixture), so
that on a machine without JAX they run with

    python -m pytest --noconftest -m cuda tests/test_torch_api_captured.py -q
"""

import contextlib
import gc
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from npe_tpu_torch.api import IAN
from npe_tpu_torch.editor.engine import EditSession
from npe_tpu_torch.models import get_config
from npe_tpu_torch.ops.kernels import rgb_beta_tail as rt
from npe_tpu_torch.serving import InferenceServer
from npe_tpu_torch.utils import graphs
from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain
from npe_tpu_torch.utils.ranges import to_tanh

HERE = pathlib.Path(__file__).resolve().parent
TINY = {"IAN_simple": (str(HERE / "tiny_ian_torch.py"), "tests/tiny_ian.py"),
        "IANv1": (str(HERE / "tiny_ianv1_torch.py"), "tests/tiny_ianv1.py"),
        "IAN": (str(HERE / "tiny_ian_full_torch.py"), "tests/tiny_ian_full.py")}
# every model and form api.IAN runs
FORMS = {"IAN_simple": ("IAN_simple", {}), "IANv1 hybrid": ("IANv1", {"head_mode": "hybrid"}),
         "IANv1 fused": ("IANv1", {"head_mode": "fused"}), "IAN plain": ("IAN", {"mdblock_mode": "plain"}),
         "IAN fused": ("IAN", {"mdblock_mode": "fused"})}
# the brush of the API scripts: moved, resized, and past the image's edge
BOXES = ((10, 12, 20, 22), (30, 5, 50, 25), (0, 40, 12, 64), (-3, 60, 4, 70))
WAIT = 60
torch.set_num_threads(1)  # torch_parity.torch_threads' rule: one intra-op thread a test worker


@pytest.fixture(scope="module")
def jax_side():
    """(torch_parity, npe_tpu's api.IAN, npe_tpu's EditSession), imported here
    so that the module itself imports no JAX."""
    import torch_parity
    from npe_tpu.api import IAN as JaxIAN
    from npe_tpu.editor.engine import EditSession as JaxSession

    return torch_parity, JaxIAN, JaxSession


def _unit_gain_variables(model, device="cpu"):
    seeded = get_config(TINY[model][0]).init(torch.Generator().manual_seed(0), "cpu")
    return from_reference(unit_gain(to_reference(seeded), iaf_logsigma_gain=0.1), device)


# --- the cache ------------------------------------------------------------------


class _Owner:
    """An owner of a cache whose function is a bound method, as api.IAN's."""

    def __init__(self, device="cpu", eager=False):
        self.scale = torch.tensor(2.0, device=device)
        self.programs = graphs.ProgramCache(device, eager)
        self.programs.define("f", self.f)
        self.runs = 0

    def f(self, x, y):
        self.runs += 1
        return x * self.scale + y.sum(), (x > 0).to(torch.uint8)


class _Holder:
    """An owner of a cache whose function "f" runs `fn` (a cache takes bound
    methods only)."""

    def __init__(self, fn, eager=False):
        self.fn = fn
        self.programs = graphs.ProgramCache("cpu", eager)
        self.programs.define("f", self.f)

    def f(self, *args):
        return self.fn(*args)


def test_one_program_per_signature_and_a_new_one_only_for_a_new_shape_or_dtype():
    """Values never make a signature: a new one comes with a new shape or a
    new dtype."""
    owner = _Owner()
    rng = np.random.RandomState(0)
    x, y = rng.randn(2, 3).astype(np.float32), rng.randn(3).astype(np.float32)
    for _ in range(3):
        x, y = x + 1, y - 1
        got, mask = owner.programs("f", x, y)
        np.testing.assert_array_equal(got, x * 2 + y.sum(dtype=np.float32))
        np.testing.assert_array_equal(mask, (x > 0).astype(np.uint8))
    assert len(owner.programs.signatures) == 1 and owner.programs.first_calls == 1
    (sig,) = owner.programs.signatures.values()
    assert sig.program.calls == 3 and owner.runs == 3
    owner.programs("f", x[:1], y)  # a new shape
    owner.programs("f", x.astype(np.float64), y)  # a new dtype
    owner.programs("f", x, y)  # an old signature
    assert len(owner.programs.signatures) == 3 and owner.programs.first_calls == 3
    shapes = sorted((key[1][0][0], str(key[1][0][1])) for key in owner.programs.signatures)
    assert shapes == [((1, 3), "torch.float32"), ((2, 3), "torch.float32"), ((2, 3), "torch.float64")]


def test_padding_to_a_bucket_gives_one_signature_and_cuts_the_pad_rows():
    """`pad_to` pads the host inputs with zero rows (the staged rows of an
    earlier, longer call are cleared) and cuts the outputs back; inputs of
    unlike rows, or more rows than the bucket, are refused."""
    seen = []

    def f(x):
        seen.append(x.clone())
        return x + 1

    holder = _Holder(f)
    cache = holder.programs
    rng = np.random.RandomState(1)
    for n in (3, 1, 4, 2):
        x = rng.randn(n, 5).astype(np.float32)
        np.testing.assert_array_equal(cache("f", x, pad_to=4), x + 1)
        assert seen[-1].shape == (4, 5) and not seen[-1][n:].any()
    assert len(cache.signatures) == 1
    with pytest.raises(ValueError, match="rows"):
        cache("f", rng.randn(5, 5).astype(np.float32), pad_to=4)
    with pytest.raises(ValueError, match="rows"):
        cache("f", np.zeros((2, 5), np.float32), np.zeros((3, 5), np.float32), pad_to=4)


def test_a_failing_first_call_leaves_no_signature_and_tensors_from_elsewhere_are_refused():
    holder = _Holder(lambda x: x.reshape(7))
    cache = holder.programs
    with pytest.raises(RuntimeError):
        cache("f", np.zeros((2, 3), np.float32))
    assert not cache.signatures and cache.first_calls == 1
    assert cache("f", np.arange(7, dtype=np.float32)).tolist() == list(range(7))
    with pytest.raises(TypeError, match="meta"):  # inputs come from the host
        cache("f", torch.zeros(7, device="meta"))


def test_outputs_come_back_as_arrays_of_their_own():
    """Each output is a copy of the download: the next call overwrites none
    of an earlier call's results."""
    owner = _Owner()
    first = owner.programs("f", np.ones((2, 3), np.float32), np.zeros(3, np.float32))
    owner.programs("f", -np.ones((2, 3), np.float32), np.zeros(3, np.float32))
    assert (first[0] == 2).all() and (first[1] == 1).all()
    (sig,) = owner.programs.signatures.values()
    assert all(not np.shares_memory(a, h) for a, h in zip(first, sig.host_outputs))


def test_an_owner_that_holds_its_cache_is_freed_without_the_cyclic_collector():
    import gc
    import weakref

    owner = _Owner()
    owner.programs("f", np.ones((2, 3), np.float32), np.zeros(3, np.float32))
    ref = weakref.ref(owner)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del owner
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


@contextlib.contextmanager
def _fake_capture(graph, pool=None, stream=None, capture_error_mode="global"):
    _fake_capture.modes.append(capture_error_mode)
    yield


def test_each_signature_runs_eagerly_then_captures_then_replays(monkeypatch):
    """Through a stand-in for the CUDA graph: a signature's first call runs
    the function eagerly and captures it ("thread_local"), counting the
    eager call's launches and none for the capture; each later call of that
    signature replays and adds the capture's launches; `first_calls` counts
    the signatures made, and an eager cache never captures."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(graphs, "_on", lambda stream: contextlib.nullcontext())
    _fake_capture.modes = []

    def f(x):
        rt.count_launch(rt.rgb_beta_tail, torch.float32)
        return x * 2

    holder = _Holder(f)
    cache = holder.programs
    cache.stream = object()  # as on the card
    start, replays = rt.rgb_beta_tail.launches, _FakeGraph.replays
    for n, call in enumerate((1, 1, 1, 2, 2), 1):
        cache("f", np.ones((call, 3), np.float32))
    assert rt.rgb_beta_tail.launches - start == 5 and _FakeGraph.replays - replays == 3
    assert cache.captures() == {key: 1 for key in cache.signatures} and len(cache.signatures) == 2
    assert cache.first_calls == 2 and _fake_capture.modes == ["thread_local"] * 2
    assert all(s.first_call_ms > 0 for s in cache.signatures.values())
    eager_holder = _Holder(f, eager=True)
    eager = eager_holder.programs
    eager("f", np.ones((1, 3), np.float32))
    eager("f", np.ones((1, 3), np.float32))
    assert eager.captures() == {key: 0 for key in eager.signatures} and eager.stream is None


def test_a_capture_records_only_its_own_threads_launches_and_captures_take_turns(monkeypatch):
    """Through a stand-in for the CUDA graph, three threads at once: while A
    captures, B's eager launches count once on the counters and never in
    A's `recorded` (so A's replays do not launch them again); C's capture
    waits until A's has ended; the cyclic collector is off from the start
    of each capture to its end, and on again after the last."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(graphs, "_on", lambda stream: contextlib.nullcontext())
    _fake_capture.modes = []
    inside, go_on, c_started = threading.Event(), threading.Event(), threading.Event()
    order, collector = [], {}
    runs = []

    def body_a():
        runs.append(1)
        rt.count_launch(rt.rgb_beta_tail, torch.float32)
        if len(runs) == 2:  # the capture
            order.append("a in")
            collector["a"] = gc.isenabled()
            inside.set()
            assert go_on.wait(WAIT)
            order.append("a out")

    def body_c():
        order.append("c")
        collector["c"] = gc.isenabled()
        rt.count_launch(rt.rgb_beta_tail, torch.bfloat16)

    a = graphs.Program(body_a, stream=object(), pure=True)
    before, collecting = graphs.read_counts(), gc.isenabled()
    got = {}
    threads = [threading.Thread(target=a),
               threading.Thread(target=lambda: (c_started.set(), got.update(c=graphs.capture(body_c, None, None))))]
    threads[0].start()
    assert inside.wait(WAIT)
    for _ in range(3):  # thread B, eager
        rt.count_launch(rt.rgb_beta_tail, torch.float32)
    threads[1].start()
    assert c_started.wait(WAIT)
    time.sleep(0.2)
    assert order == ["a in"] and not gc.isenabled()
    go_on.set()
    for t in threads:
        t.join(WAIT)
    assert order == ["a in", "a out", "c"] and collector == {"a": False, "c": False}
    assert gc.isenabled() == collecting
    launches = graphs.COUNTERS.index((rt.rgb_beta_tail, "launches"))
    bf16 = graphs.COUNTERS.index((rt.rgb_beta_tail, "launches_bf16"))
    assert a.recorded == [int(i == launches) for i in range(len(graphs.COUNTERS))]
    assert got["c"][1] == [int(i == bf16) for i in range(len(graphs.COUNTERS))]
    delta = [n - b for n, b in zip(graphs.read_counts(), before)]
    assert delta == [4 * (i == launches) for i in range(len(graphs.COUNTERS))]  # A's eager call and B's 3
    a()
    assert graphs.read_counts()[launches] - before[launches] == 5 and len(runs) == 2


# --- no host reads --------------------------------------------------------------


@pytest.mark.parametrize("form", sorted(FORMS))
def test_no_api_body_reads_a_device_value_to_the_host(form):
    """Each of api.IAN's bodies on tensors, under a guard that raises on any
    read of a tensor's value to the host: what a CUDA graph cannot take."""
    from test_torch_captured import no_host_reads

    model, options = FORMS[form]
    ian = IAN(TINY[model][0], variables=_unit_gain_variables(model), device="cpu", **options)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))
    z = torch.from_numpy(rng.randn(1, 16).astype(np.float32))
    box = torch.tensor([10.0, 12.0, 30.0, 25.0])
    rgb = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp, no_host_reads(mp):
        outs = [ian._encode(x), ian._sample(z), ian._patch_loss_grad(z, box), ian._patch_loss_grad(z, box, rgb)]
    assert all(torch.isfinite(o).all() for o in outs) and outs[2].abs().max() > 0


@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("model", ["IAN_simple", "IANv1"])
def test_no_served_body_reads_a_device_value_to_the_host(model, wire):
    from test_torch_captured import no_host_reads

    server = InferenceServer(TINY[model][0], variables=_unit_gain_variables(model), device="cpu", wire=wire,
                             max_batch=4)
    try:
        rng = np.random.RandomState(3)
        x = torch.from_numpy(rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32))
        if wire == "uint8":
            x = torch.from_numpy(rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8))
        z = torch.from_numpy(rng.randn(4, 16).astype(np.float32))
        with pytest.MonkeyPatch.context() as mp, no_host_reads(mp):
            zs, y = server._encode_body(x), server._decode_body(z)
    finally:
        server.close()
    assert zs.shape == (4, 16) and y.shape == (4, 64, 64, 3)
    assert y.dtype == (torch.uint8 if wire == "uint8" else torch.float32)


# --- api.IAN against npe_tpu ----------------------------------------------------


def _api_script(ian, seed=5):
    """encode_images and sample_at at batch 1 and 3, and imgrad / imgradRGB
    at batch 1 under every box of BOXES, each with another colour and other
    latents. Returns every output."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (3, 3, 64, 64)).astype(np.float32)
    outs = [ian.encode_images(x[:1]), ian.encode_images(x)]
    z = outs[1]
    outs += [ian.sample_at(z[:1]), ian.sample_at(z)]
    for box in BOXES:
        z1 = rng.randn(1, 16).astype(np.float32)
        rgb = np.broadcast_to(rng.uniform(-1, 1, (1, 3, 1, 1)), (1, 3, 64, 64)).astype(np.float32)
        outs += [ian.imgrad(*box, z1), ian.imgradRGB(*box, rgb, z1)]
    return outs


@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_api_through_its_programs_matches_npe_tpu_with_a_moving_brush(jax_side, form):
    """Every method of the port's api.IAN through its programs against
    npe_tpu's jitted methods on the same variables (full IAN with its BN
    state moved off the identity), the box moved and resized between the
    calls: six signatures, one program each, whatever the box, colour or
    latents."""
    tp, JaxIAN, _ = jax_side
    model, options = FORMS[form]
    config, jax_config = TINY[model]
    jv = tp.jax_variables(jax_config)
    if model == "IAN":
        jv = tp.with_bn_state(jv, seed=7)
    jian = JaxIAN(config_path=jax_config, variables=tp.as_jax(jv))
    tian = IAN(config, variables=from_reference(jv, "cpu"), device="cpu", **options)
    got = _api_script(tian)
    want = _api_script(jian)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        tp.assert_close(g, w)
    assert all(np.abs(g).max() > 1e-3 for g in got[4:])  # real gradients, not a vacuous match
    calls = {(key[0], key[1][0][0]): s.program.calls for key, s in tian.programs.signatures.items()}
    assert calls == {("encode", (1, 3, 64, 64)): 1, ("encode", (3, 3, 64, 64)): 1, ("sample", (1, 16)): 1,
                     ("sample", (3, 16)): 1, ("imgrad", (1, 16)): len(BOXES), ("imgrad_rgb", (1, 16)): len(BOXES)}


def test_the_api_is_thread_safe():
    """Threads sharing one api.IAN each get the gradient of their own box
    and latents (the lock makes a call atomic), equal to a lone call's."""
    import threading

    ian = IAN(TINY["IAN_simple"][0], variables=_unit_gain_variables("IAN_simple"), device="cpu")
    rng = np.random.RandomState(9)
    jobs = [((i, i, 20 + i, 24 + i), rng.randn(1, 16).astype(np.float32)) for i in range(8)]
    want = [ian.imgrad(*box, z) for box, z in jobs]
    got = [None] * len(jobs)

    def work(i):
        for _ in range(3):
            got[i] = ian.imgrad(*jobs[i][0], jobs[i][1])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --- the editor's encode and decode programs --------------------------------------


@pytest.mark.parametrize("form", ["IAN_simple", "IANv1 fused", "IAN fused"])
def test_the_editors_load_sample_and_decode_match_npe_tpu(jax_side, form, monkeypatch):
    """infer (the runner's encode and decode programs), decode_current, then
    sample with npe_tpu's latents (the packages draw other ones; the port's
    draw is replaced by npe_tpu's), reset and update_gim, against npe_tpu's
    session: Z, RECON (the uint8 rule), ERROR and IM."""
    tp, _, JaxSession = jax_side
    model, options = FORMS[form]
    config, jax_config = TINY[model]
    jv = tp.jax_variables(jax_config)
    if model == "IAN":
        jv = tp.with_bn_state(jv, seed=5)
    js = JaxSession(config=jax_config, variables=tp.as_jax(jv), dim=(4, 4), use_pallas=False)
    ts = EditSession(config=config, variables=from_reference(jv, "cpu"), dim=(4, 4), device="cpu", **options)
    image = (np.random.RandomState(3).rand(3, 64, 64).astype(np.float32) * 2 - 1) * 0.5

    def same():
        tp.assert_close(ts.Z.numpy(), np.asarray(js.Z))
        tp.assert_recon_close(ts.RECON, js.RECON)
        tp.assert_im_close(ts.IM, js.IM, ts.RECON, js.RECON)
        tp.assert_close(ts.ERROR, js.ERROR, atol=tp.UINT8_STEP + tp.ATOL)

    for s in (js, ts):
        s.infer(image)
    same()
    tp.assert_close(ts.decode_current(), js.decode_current())
    js.sample(3)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "randn", lambda *a, **k: torch.from_numpy(np.array(js.Z, np.float32)))
        ts.sample(3)
    same()
    tp.assert_close(ts.decode_current(), js.decode_current())
    for op in ("reset", "update_gim"):
        getattr(js, op)()
        getattr(ts, op)()
        same()
    calls = {kind: p.calls for kind, p in ts.runner.programs.items()}
    assert calls == {"paint": 0, "scroll": 0, "composite": 0, "encode": 3, "decode": 6}, calls


# --- on the card -----------------------------------------------------------------


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_captured_api_captures_once_and_equals_eager_on_the_card(cuda, form, dtype):
    """The API script on the tiny profiles, captured and eager, from the same
    weights, under deterministic algorithms: equal bit for bit; each of the
    six signatures captured once while the box, colour and latents changed."""
    model, options = FORMS[form]
    variables = _unit_gain_variables(model, cuda)
    with _deterministic():
        captured, eager = (IAN(TINY[model][0], variables=variables, device=cuda, dtype=dtype, eager=e, **options)
                           for e in (False, True))
        got, want = _api_script(captured), _api_script(eager)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert list(captured.programs.captures().values()) == [1] * 6
    assert not any(eager.programs.captures().values())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_captured_server_equals_eager_on_the_card(cuda, form, wire):
    """Sequential requests of 1, 3, 5 and 10 images at max_batch 8 (buckets
    1, 4 and 8, and 10 split into 8 + 2), captured and eager, under
    deterministic algorithms: equal bit for bit, one capture a bucket."""
    model, options = FORMS[form]
    variables = _unit_gain_variables(model, cuda)
    rng = np.random.RandomState(4)
    x = to_tanh(np.float32(rng.randint(0, 256, (10, 64, 64, 3))))
    outs, caps = {}, {}
    with _deterministic():
        for eager in (False, True):
            server = InferenceServer(TINY[model][0], variables=variables, device=cuda, wire=wire, max_batch=8,
                                     eager=eager, **options)
            try:
                zs = [server.encode(x[:n]).result(timeout=WAIT) for n in (1, 3, 5, 10)]
                outs[eager] = zs + [server.decode(z).result(timeout=WAIT) for z in zs]
                caps[eager] = sorted((key[0], key[1][0][0][0], n) for key, n in server.programs.captures().items())
            finally:
                server.close()
    for g, w in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(g, w)
    assert caps[False] == [(op, b, 1) for op in ("decode", "encode") for b in (1, 2, 4, 8)]
    assert all(n == 0 for *_, n in caps[True])


@pytest.mark.cuda
def test_the_editors_encode_and_decode_capture_once_on_the_card(cuda):
    """infer, reset, sample and decode_current on the card: the encode and
    decode programs captured once each, their results those of an eager
    session bit for bit under deterministic algorithms."""
    variables = _unit_gain_variables("IANv1", cuda)
    image = (np.random.RandomState(3).rand(3, 64, 64).astype(np.float32) * 2 - 1) * 0.5
    results = {}
    with _deterministic():
        for eager in (False, True):
            s = EditSession(TINY["IANv1"][0], variables=variables, dim=(4, 4), device=cuda, eager=eager)
            s.infer(image)
            s.reset()
            s.sample(5)
            results[eager] = (s.Z.cpu().numpy(), s.IM, s.RECON, s.ERROR, s.decode_current())
            if not eager:
                assert {k: p.captures for k, p in s.runner.programs.items() if k in ("encode", "decode")} == {
                    "encode": 1, "decode": 1}
    for g, w in zip(results[False], results[True]):
        np.testing.assert_array_equal(g, w)
