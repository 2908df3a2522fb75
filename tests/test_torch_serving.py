"""npe_tpu_torch's micro-batching InferenceServer on the CPU, mirroring
tests/test_serving.py at the tiny profiles: served results are held against
npe_tpu's `module.encode` / `decode` on the same weights."""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu.models import get_config as jax_config
from npe_tpu.utils.ranges import from_tanh, to_tanh
from npe_tpu_torch.ops.kernels import staging
from npe_tpu_torch.serving import InferenceServer, ModelHost, main, serve_http

tp.torch_threads()
WAIT = 60  # seconds: the longest any future, request or join may take here
ZDIM = 16


@pytest.fixture(scope="module")
def jax_module():
    return jax_config(tp.TINY_JAX)


@pytest.fixture(scope="module")
def jax_vars():
    return tp.jax_variables(tp.TINY_JAX)


@pytest.fixture(scope="module")
def port_vars():
    return tp.port_variables(tp.TINY_JAX)


@pytest.fixture
def make_server(port_vars):
    """InferenceServers on the CPU over the tiny profile's seeded weights
    (unless `variables` or `config` says otherwise), closed at the end."""
    made = []

    def make(**kw):
        kw = {"config": tp.TINY_TORCH, "variables": port_vars, "device": "cpu", **kw}
        s = InferenceServer(**kw)
        made.append(s)
        return s

    yield make
    for s in made:
        s.close()
        assert not s._thread.is_alive()


@pytest.fixture
def http():
    """serve_http on an ephemeral port in a thread; shut down at the end."""
    started = []

    def start(target):
        httpd = serve_http(target, port=0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        started.append((httpd, t))
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    yield start
    for httpd, t in started:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=WAIT)
        assert not t.is_alive()


@pytest.fixture(scope="module")
def server(port_vars):
    s = InferenceServer(config=tp.TINY_TORCH, variables=port_vars, max_batch=8, linger_ms=5.0, device="cpu")
    yield s
    s.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return np.asarray(json.load(r)["result"], np.float32)


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT) as r:
        return json.load(r)


def test_roundtrip_matches_direct(server, jax_module, jax_vars):
    x = np.random.RandomState(0).rand(3, 64, 64, 3).astype(np.float32) * 2 - 1
    z = server.encode(x).result(timeout=WAIT)
    assert z.shape == (3, ZDIM) and z.dtype == np.float32
    tp.assert_close(z, np.asarray(jax_module.encode(jax_vars, x)))
    imgs = server.decode(z).result(timeout=WAIT)
    assert imgs.shape == (3, 64, 64, 3)  # NHWC, as npe_tpu's server returns
    want = np.asarray(jax_module.decode(jax_vars, z))
    assert want.std() > 0.1
    tp.assert_close(imgs, want)


def test_concurrent_requests_batched(server, jax_module, jax_vars):
    rng = np.random.RandomState(1)
    zs = [rng.randn(2, ZDIM).astype(np.float32) for _ in range(6)]
    before = dict(server.stats)
    futs = [server.decode(z) for z in zs]
    outs = [f.result(timeout=WAIT) for f in futs]
    assert all(o.shape == (2, 64, 64, 3) for o in outs)
    assert not np.allclose(outs[0], outs[1])  # different inputs -> different outputs
    for z, o in zip(zs, outs):
        tp.assert_close(o, np.asarray(jax_module.decode(jax_vars, z)))
    assert server.stats["batched_items"] - before["batched_items"] == 6
    assert server.stats["batches"] - before["batches"] <= 6


def test_oversize_group_split(server, jax_module, jax_vars):
    z = np.random.RandomState(2).randn(20, ZDIM).astype(np.float32)  # > max_batch
    out = server.decode(z).result(timeout=WAIT)
    assert out.shape == (20, 64, 64, 3)
    tp.assert_close(out[:2], np.asarray(jax_module.decode(jax_vars, z[:2])))
    with torch.no_grad():
        tp.assert_close(out, tp.nhwc(server.module.decode(server.variables, torch.from_numpy(z))))


def test_mixed_ops_all_resolve(server):
    """Interleaved encode/decode requests all complete (the op switch parks
    the request at the FRONT of the pending deque), in FIFO order."""
    rng = np.random.RandomState(3)
    futs, done = [], []
    for i in range(8):
        if i % 2:
            f = server.decode(rng.randn(1, ZDIM).astype(np.float32))
        else:
            f = server.encode(rng.rand(1, 64, 64, 3).astype(np.float32))
        f.add_done_callback(lambda _, i=i: done.append(i))
        futs.append(("d" if i % 2 else "e", f))
    for kind, f in futs:
        out = f.result(timeout=WAIT)
        assert out.shape == ((1, ZDIM) if kind == "e" else (1, 64, 64, 3))
    assert done == sorted(done)  # each group ends before the next starts


def test_request_timeout(make_server):
    """A request whose deadline passes while queued fails with TimeoutError
    instead of occupying batch slots."""
    s = make_server(max_batch=4, linger_ms=1.0)
    s.decode(np.zeros((1, ZDIM), np.float32)).result(timeout=WAIT)
    blocker = s.decode(np.zeros((4, ZDIM), np.float32))
    doomed = s.decode(np.zeros((1, ZDIM), np.float32), timeout=1e-4)
    time.sleep(0.05)
    with pytest.raises(TimeoutError):
        doomed.result(timeout=WAIT)
    blocker.result(timeout=WAIT)
    assert s.stats["timeouts"] == 1


def test_kernel_error_propagates(server):
    """A bad input shape fails THAT request's future; the server survives."""
    bad = server.decode(np.zeros((2, 7), np.float32))  # wrong latent width
    with pytest.raises(RuntimeError):
        bad.result(timeout=WAIT)
    ok = server.decode(np.zeros((2, ZDIM), np.float32)).result(timeout=WAIT)
    assert ok.shape == (2, 64, 64, 3)


def test_unlike_shapes_in_one_group_fail_the_group_not_the_dispatcher(make_server):
    """Requests that cannot be stacked into one batch fail their group's
    futures (npe_tpu stacks them outside its error handling)."""
    s = make_server(max_batch=8, linger_ms=200.0)
    futs = [s.decode(np.zeros((1, 7), np.float32)), s.decode(np.zeros((1, ZDIM), np.float32))]
    for f in futs:
        with pytest.raises(ValueError):
            f.result(timeout=WAIT)
    assert s.stats["errors"] == 2 and s._thread.is_alive()
    assert s.decode(np.zeros((1, ZDIM), np.float32)).result(timeout=WAIT).shape == (1, 64, 64, 3)


def test_http_transport(make_server, http, jax_module, jax_vars):
    """JSON-over-HTTP round trip against the in-process server."""
    s = make_server(max_batch=4, linger_ms=1.0)
    url = http(s)
    assert _get(url + "/healthz")["ok"] is True
    assert _get(url + "/models") == {"models": ["default"], "default": "default"}
    z = np.random.RandomState(4).randn(2, ZDIM).astype(np.float32)
    out = _post(url + "/decode", {"data": z.tolist()})
    assert out.shape == (2, 64, 64, 3)
    tp.assert_close(out, np.asarray(jax_module.decode(jax_vars, z)))
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    np.testing.assert_array_equal(_post(url + "/encode", {"data": x.tolist()}), s.encode(x).result(timeout=WAIT))
    stats = _get(url + "/stats")
    assert stats["requests"] >= 2 and stats["batches"] >= 2
    for path, code in (("/nope/decode/x", 404), ("/transcode", 404), ("/default/decode", 404)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + path, {"data": z.tolist()})
        assert ei.value.code == code
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url + "/decode", {"nodata": 1})
    assert ei.value.code == 400


def test_slo_shortens_linger(make_server):
    """A tight-SLO request dispatches well before the linger window expires;
    requests without an SLO still aggregate into one batch."""
    s = make_server(max_batch=2, linger_ms=4000.0)
    # the first call's sample seeds the group-time EMA the SLO cap needs
    s.decode(np.zeros((2, ZDIM), np.float32)).result(timeout=WAIT)
    assert s._kernel_ema["decode"] is not None
    t0 = time.perf_counter()
    out = s.decode(np.zeros((1, ZDIM), np.float32), slo=0.3).result(timeout=WAIT)
    dt = time.perf_counter() - t0
    assert out.shape == (1, 64, 64, 3)
    assert dt < 3.0, dt  # the 4 s linger alone would exceed this; the SLO preempted it
    assert s.stats["slo_tightened"] >= 1
    # a no-SLO pair submitted back to back -> ONE batch (it fills max_batch)
    b0 = s.stats["batches"]
    f1 = s.decode(np.zeros((1, ZDIM), np.float32))
    f2 = s.decode(np.zeros((1, ZDIM), np.float32))
    f1.result(timeout=WAIT)
    f2.result(timeout=WAIT)
    assert s.stats["batches"] == b0 + 1


def test_multi_model_host_http(make_server, http):
    """Two models in one process: per-model routes, default route, /models
    listing, per-model stats, 404 on an unknown model."""
    host = ModelHost()
    host.add("a", make_server(max_batch=4, linger_ms=1.0))
    host.add("b", make_server(variables=None, seed=1, max_batch=4, linger_ms=1.0))
    with pytest.raises(KeyError):
        host.add("a", host.get("b"))
    url = http(host)
    assert _get(url + "/models") == {"models": ["a", "b"], "default": "a"}
    z = np.random.RandomState(5).randn(2, ZDIM).astype(np.float32).tolist()
    out_a = _post(url + "/a/decode", {"data": z, "slo_ms": 50.0})
    out_b = _post(url + "/b/decode", {"data": z})
    out_default = _post(url + "/decode", {"data": z})
    assert out_a.shape == out_b.shape == (2, 64, 64, 3)
    assert not np.allclose(out_a, out_b)  # different weights
    np.testing.assert_allclose(out_default, out_a, rtol=1e-5, atol=1e-6)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url + "/nope/decode", {"data": z})
    assert ei.value.code == 404
    stats = _get(url + "/stats")
    assert set(stats) == {"a", "b"} and stats["a"]["requests"] >= 2


def test_uint8_wire_roundtrip(make_server, jax_module, jax_vars):
    """wire='uint8' ships image payloads as uint8 but keeps the float32
    [-1, 1] public API; the encode's range change runs through the staging
    kernel's wrapper (its plain version on the CPU, no launch)."""
    s = make_server(max_batch=4, linger_ms=2.0, wire="uint8")
    rng = np.random.RandomState(7)
    u8 = rng.randint(0, 256, size=(3, 64, 64, 3)).astype(np.uint8)
    x = to_tanh(np.float32(u8))  # grid-aligned client input
    launches = staging.stage_chunk.launches
    z = s.encode(x).result(timeout=WAIT)
    assert staging.stage_chunk.launches == launches
    tp.assert_close(z, np.asarray(jax_module.encode(jax_vars, x)))
    imgs = s.decode(z).result(timeout=WAIT)
    assert imgs.dtype == np.float32 and imgs.shape == (3, 64, 64, 3)
    # the host-side quantisation of the port's own direct decode, exactly ...
    with torch.no_grad():
        direct = tp.nhwc(s.module.decode(s.variables, torch.from_numpy(z)))
    np.testing.assert_allclose(imgs, to_tanh(np.float32(np.clip(np.round(from_tanh(direct)), 0, 255))),
                               rtol=0, atol=1e-6)
    # ... that of npe_tpu's decode, but where a value rounds across a half step ...
    want = np.asarray(jax_module.decode(jax_vars, z))
    tp.assert_recon_close(imgs, to_tanh(np.float32(np.clip(np.round(from_tanh(want)), 0, 255))))
    # ... and within one quantisation step of the raw decode
    assert np.max(np.abs(imgs - want)) <= tp.UINT8_STEP + 1e-6


def test_uint8_wire_tail_and_split(make_server, jax_module, jax_vars):
    """uint8 wire with a group over max_batch behaves like float32."""
    s = make_server(max_batch=4, linger_ms=2.0, wire="uint8")
    z = np.random.RandomState(8).randn(10, ZDIM).astype(np.float32)  # > max_batch
    out = s.decode(z).result(timeout=WAIT)
    assert out.shape == (10, 64, 64, 3)
    assert np.max(np.abs(out[:3] - np.asarray(jax_module.decode(jax_vars, z[:3])))) <= tp.UINT8_STEP + 1e-6
    with torch.no_grad():
        direct = tp.nhwc(s.module.decode(s.variables, torch.from_numpy(z)))
    assert np.max(np.abs(out - direct)) <= tp.UINT8_STEP + 1e-6


def test_uint8_wire_accepts_raw_uint8_input(make_server):
    """A uint8 [0, 255] image array is taken as it is and yields exactly the
    z of the equivalent float32 input."""
    s = make_server(max_batch=4, linger_ms=2.0, wire="uint8")
    u8 = np.random.RandomState(9).randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8)
    z_u8 = s.encode(u8).result(timeout=WAIT)
    z_f32 = s.encode(to_tanh(np.float32(u8))).result(timeout=WAIT)
    np.testing.assert_array_equal(z_u8, z_f32)


# --- what the port adds --------------------------------------------------------

FORMS = [(tp.TINY_V1_TORCH, "head_mode", m) for m in ("plain", "hybrid", "fused")] + [
    (tp.TINY_FULL_TORCH, "mdblock_mode", m) for m in ("plain", "fused")]


@pytest.fixture(scope="module")
def unit_gain_vars():
    """Seeded unit-gain port variables of the tiny IANv1 and full-IAN
    profiles, made without JAX (their decodes are held against npe_tpu's in
    test_torch_models.py)."""
    from npe_tpu_torch.models import get_config
    from npe_tpu_torch.utils.checkpoints import from_reference, to_reference, unit_gain

    return {cfg: from_reference(unit_gain(to_reference(get_config(cfg).init(torch.Generator().manual_seed(0), "cpu")),
                                          iaf_logsigma_gain=tp.IAF_LOGSIGMA_GAIN), "cpu")
            for cfg in (tp.TINY_V1_TORCH, tp.TINY_FULL_TORCH)}


@pytest.mark.parametrize("config,option,mode", FORMS)
def test_decode_forms_reach_every_served_decode(make_server, unit_gain_vars, config, option, mode):
    """head_mode / mdblock_mode reach each decode of a group: every form
    gives the port's direct decode in that form, and an unknown form fails
    every request."""
    tv = unit_gain_vars[config]
    s = make_server(config=config, variables=tv, max_batch=2, linger_ms=50.0, **{option: mode})
    assert s.decode_options == {option: mode}
    z = np.random.RandomState(10).randn(3, ZDIM).astype(np.float32)
    futs = [s.decode(z[i:i + 1]) for i in range(3)]
    out = np.concatenate([f.result(timeout=WAIT) for f in futs])
    with torch.no_grad():
        want = tp.nhwc(s.module.decode(tv, torch.from_numpy(z), **{option: mode}))
    assert want.std() > 0.1
    tp.assert_close(out, want)
    bogus = make_server(config=config, variables=tv, max_batch=2, linger_ms=50.0, **{option: "bogus"})
    for f in [bogus.decode(z[i:i + 1]) for i in range(3)]:
        with pytest.raises(ValueError, match="bogus"):
            f.result(timeout=WAIT)


@pytest.mark.parametrize("dtype", [torch.float16, np.float64])
def test_other_dtypes_are_refused(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        InferenceServer(config=tp.TINY_TORCH, device="cpu", dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, "bfloat16"])
def test_bf16_server_decodes_close_to_npe_tpus_bf16_server(make_server, jax_vars, port_vars, dtype):
    """A bf16 server (weights cast once, float32 out) against npe_tpu's
    `InferenceServer(dtype=jnp.bfloat16)` on the same weights: within twice
    the gap bf16 opens against the port's float32 server, and that gap within
    npe_tpu's own bound of 0.05 mean abs (tests/test_api_bf16.py)."""
    import jax.numpy as jnp

    from npe_tpu.serving import InferenceServer as JaxServer

    z = np.random.RandomState(9).randn(3, ZDIM).astype(np.float32)
    s16 = make_server(dtype=dtype)
    assert s16.dtype is torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in s16.variables.values())
    assert port_vars["dec_out.W"].dtype == torch.float32  # the caller's variables are not cast in place
    got = s16.decode(z).result(timeout=WAIT)
    ref32 = make_server().decode(z).result(timeout=WAIT)
    js = JaxServer(config=tp.TINY_JAX, variables=jax_vars, max_batch=8, dtype=jnp.bfloat16)
    try:
        want = js.decode(z).result(timeout=WAIT)
    finally:
        js.close()
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 64, 64, 3)
    own = np.abs(got - ref32).mean()
    assert 0 < own < 0.05
    assert np.abs(got - want).mean() <= 2 * own


@pytest.mark.parametrize("dtype", [None, torch.float32, np.float32, "float32"])
def test_float32_is_served(make_server, dtype):
    s = make_server(dtype=dtype)
    assert s.decode(np.zeros((1, ZDIM), np.float32)).result(timeout=WAIT).dtype == np.float32


def test_bf16_flag_builds_a_bf16_server(monkeypatch):
    """`--bf16` serves in bf16, as npe_tpu's `--bf16` does: main's server
    holds bf16 weights and answers in float32 (its HTTP loop replaced by one
    decode)."""
    import npe_tpu_torch.serving as serving

    seen = {}

    class OneDecode:
        server_address = ("127.0.0.1", 0)

        def __init__(self, target):
            self.target = target

        def serve_forever(self):
            seen["server"] = self.target
            seen["y"] = self.target.decode(np.zeros((1, ZDIM), np.float32)).result(timeout=WAIT)

        def server_close(self):
            pass

    monkeypatch.setattr(serving, "serve_http", lambda target, port: OneDecode(target))
    main(["--bf16", "--device", "cpu", "--config", tp.TINY_TORCH, "--port", "0"])
    assert seen["server"].dtype is torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in seen["server"].variables.values())
    assert seen["y"].dtype == np.float32 and seen["y"].shape == (1, 64, 64, 3) and np.isfinite(seen["y"]).all()
    main(["--device", "cpu", "--config", tp.TINY_TORCH, "--port", "0"])
    assert seen["server"].dtype is torch.float32


def test_unknown_wire_is_refused():
    with pytest.raises(ValueError, match="wire"):
        InferenceServer(config=tp.TINY_TORCH, device="cpu", wire="float16")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(config=tp.TINY_TORCH)


def test_the_dispatcher_runs_in_inference_mode(make_server):
    """Grad mode is thread-local: the dispatcher thread sets its own."""
    s = make_server()
    seen = []
    encode = s._kernels["encode"]
    s._kernels["encode"] = lambda x: (seen.append(torch.is_inference_mode_enabled()), encode(x))[1]
    with torch.enable_grad():
        s.encode(np.zeros((1, 64, 64, 3), np.float32)).result(timeout=WAIT)
    assert seen == [True]


def test_close_fails_what_is_still_queued(make_server):
    s = make_server(max_batch=1)
    gate = threading.Event()
    decode = s._kernels["decode"]
    s._kernels["decode"] = lambda z: (gate.wait(WAIT), decode(z))[1]
    first = s.decode(np.zeros((1, ZDIM), np.float32))
    queued = [s.decode(np.zeros((1, ZDIM), np.float32)) for _ in range(3)]
    s._stop.set()
    gate.set()
    s.close()
    assert first.result(timeout=WAIT).shape == (1, 64, 64, 3)
    for f in queued:
        with pytest.raises(RuntimeError, match="server closed"):
            f.result(timeout=WAIT)


def test_request_counts_survive_many_threads(make_server):
    """More submitting threads than cores, with a short switch interval:
    no request is lost, the counter counts each one once, and each request
    gets back the row its own group decoded from its own input.

    On the CPU a row decoded alone takes another GEMM path than a row of a
    larger group and differs from it in the last bits (up to about 1e-5
    after the tanh), so a row is held to the decode of its input in a group
    of the same size, not to another request's row from a group of another
    size."""
    s = make_server(max_batch=16, linger_ms=1.0)
    n_threads, per_thread = 16, 12
    futs = [[] for _ in range(n_threads)]
    decode = s._kernels["decode"]
    groups = []  # (z, rows) of every group the dispatcher decoded

    def recording(z):
        rows = decode(z)
        groups.append((z.copy(), rows.copy()))
        return rows

    s._kernels["decode"] = recording

    def submit(i):
        for _ in range(per_thread):
            futs[i].append(s.decode(np.full((1, ZDIM), i, np.float32)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    outs = {i: [f.result(timeout=WAIT) for f in fs] for i, fs in enumerate(futs)}
    assert s.stats["requests"] == n_threads * per_thread
    assert s.stats["batched_items"] == n_threads * per_thread
    assert sum(len(z) for z, _ in groups) == n_threads * per_thread
    decoded = {}  # input -> [(group size, row)] not yet claimed by a request
    for z, rows in groups:
        for zr, row in zip(z, rows):
            decoded.setdefault(int(zr[0]), []).append((len(z), row))
    refs = {}
    for i, got in outs.items():  # each request got its own row back, once
        for o in got:
            assert o.shape == (1, 64, 64, 3)
            mine = decoded.get(i, [])
            k = next((k for k, (_, row) in enumerate(mine) if np.array_equal(row, o[0])), None)
            assert k is not None, f"request {i}'s row is no row its group decoded from input {i}"
            n, _ = mine.pop(k)
            if (i, n) not in refs:
                with torch.inference_mode():
                    refs[i, n] = decode(np.full((n, ZDIM), i, np.float32))[:1]
            np.testing.assert_allclose(o, refs[i, n], rtol=1e-5, atol=1e-6)
    assert not any(decoded.values())  # and no decoded row went unclaimed
    assert not np.allclose(outs[0][0], outs[1][0])
