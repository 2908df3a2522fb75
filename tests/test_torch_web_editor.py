"""npe_tpu_torch's web editor on the CPU, mirroring tests/test_web_editor.py
at the tiny profile (16 latents, a 4x4 grid), plus a scripted comparison with
npe_tpu's EditorService on the same weights and the PNG writer's checks."""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import torch_parity as tp
from npe_tpu_torch.editor.web import EditorService, serve
from npe_tpu_torch.utils.checkpoints import save_weights
from npe_tpu_torch.utils.png import decode_rgb, encode_rgb

tp.torch_threads()
WAIT = 60
DIM = (4, 4)


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("web") / "tiny.npz"
    save_weights(str(path), tp.port_variables(tp.TINY_JAX))
    return str(path)


@pytest.fixture(scope="module")
def server_url(weights_file):
    server = serve(config=tp.TINY_TORCH, weights_path=weights_file, port=0, device="cpu", dim=DIM)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    t.join(timeout=WAIT)
    assert not t.is_alive()


def _post(url, route, body):
    req = urllib.request.Request(url + route, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


def _get(url, route):
    with urllib.request.urlopen(url + route, timeout=WAIT) as r:
        return r.read()


def _photo(state):
    return decode_rgb(base64.b64decode(state["photo_png"]))


def test_page_and_state(server_url):
    page = _get(server_url, "/")
    assert b"Neural Photo Editor" in page
    st = json.loads(_get(server_url, "/state"))
    assert "photo_png" in st and "latent_png" in st
    png = base64.b64decode(st["photo_png"])
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert _photo(st).shape == (64, 64, 3)
    assert decode_rgb(base64.b64decode(st["latent_png"])).shape == (DIM[0] * 16, DIM[1] * 16, 3)
    assert np.asarray(st["z"]).shape == DIM
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server_url, "/nope")
    assert e.value.code == 404


def test_paint_moves_latents(server_url):
    before = np.asarray(json.loads(_get(server_url, "/state"))["z"])
    st = _post(server_url, "/paint", {"x1": 10, "y1": 10, "x2": 22, "y2": 22, "rgb": [255, 0, 0]})
    after = np.asarray(st["z"])
    assert not np.allclose(before, after)


def test_sample_reset_infer_cycle(server_url):
    st = _post(server_url, "/sample", {"seed": 5})
    assert st["sample_flag"]
    st = _post(server_url, "/infer", {"index": 3})
    assert not st["sample_flag"]
    st = _post(server_url, "/reset", {})
    assert not st["sample_flag"]
    st = _post(server_url, "/update_gim", {})
    assert not st["sample_flag"]


def test_latent_painting(server_url):
    grid = np.zeros(DIM).tolist()
    grid[0][0] = 1.0
    st = _post(server_url, "/latents", {"grid": grid})
    assert abs(st["z"][0][0] - 1.0) < 1e-5
    st = _post(server_url, "/latent_cell", {"i": 2, "j": 3, "value": -0.5})
    assert abs(st["z"][2][3] + 0.5) < 1e-5


def test_latent_paint_free_form(server_url):
    """Free-form latent painting (reference `NPE.py:277-302`): Z must be the
    per-cell mean pooling of the painted canvas (16 px a cell)."""
    base = np.full(DIM, 0.25, np.float32)
    _post(server_url, "/latents", {"grid": base.tolist()})
    # an 8x8 box fully inside cell (1, 2): 64 of its 256 px
    st = _post(
        server_url,
        "/latent_paint",
        {"x1": 2 * 16 + 4, "y1": 1 * 16 + 4, "x2": 2 * 16 + 12, "y2": 1 * 16 + 12, "value": 1.0},
    )
    z = np.asarray(st["z"])
    want = (0.25 * (256 - 64) + 1.0 * 64) / 256
    assert abs(z[1][2] - want) < 1e-5
    mask = np.ones(DIM, bool)
    mask[1, 2] = False
    np.testing.assert_allclose(z[mask], 0.25, atol=1e-5)  # all other cells untouched
    # a full-cell box sets the exact value; a straddling box splits its mean
    _post(server_url, "/latents", {"grid": np.zeros(DIM).tolist()})
    st = _post(server_url, "/latent_paint", {"x1": 16, "y1": 0, "x2": 40, "y2": 16, "value": -0.5})
    z = np.asarray(st["z"])
    assert abs(z[0][1] + 0.5) < 1e-5  # fully covered cell
    assert abs(z[0][2] + 0.5 * 8 / 16) < 1e-5  # half covered
    # out-of-range boxes clamp, like the reference's max/min guards
    st = _post(server_url, "/latent_paint", {"x1": -30, "y1": -30, "x2": 8, "y2": 8, "value": 1.0})
    assert abs(np.asarray(st["z"])[0][0] - 1.0 * 64 / 256) < 1e-5


def test_unknown_route_404(server_url):
    req = urllib.request.Request(server_url + "/nope", data=b"{}", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=WAIT)
    assert e.value.code == 404


def test_undo_route(server_url):
    """/undo reverts the last stroke; the Undo button is on the page."""
    _post(server_url, "/infer", {"index": 9})
    before = np.asarray(json.loads(_get(server_url, "/state"))["z"])
    _post(server_url, "/paint", {"x1": 4, "y1": 4, "x2": 14, "y2": 14, "rgb": [0, 255, 0]})
    st = _post(server_url, "/undo", {})
    np.testing.assert_allclose(np.asarray(st["z"]), before, atol=0)
    st = _post(server_url, "/undo", {})  # empty stack: no-op, still 200
    np.testing.assert_allclose(np.asarray(st["z"]), before, atol=0)
    assert b"Undo" in _get(server_url, "/")


def test_named_sessions_isolated(server_url):
    """Multi-image editing: /session forks (shared weights, per-image
    state), /session_close removes."""
    st = _post(server_url, "/session", {"name": "img2"})
    assert st["session"] == "img2" and "main" in st["sessions"]
    z2 = np.asarray(_post(server_url, "/sample", {"seed": 11})["z"])
    st = _post(server_url, "/session", {"name": "main"})
    assert st["session"] == "main"
    assert not np.allclose(z2, np.asarray(st["z"]))
    st = _post(server_url, "/session_close", {"name": "img2"})
    assert st["sessions"] == ["main"]


def test_soft_brush_paint(server_url):
    before = np.asarray(json.loads(_get(server_url, "/state"))["z"])
    st = _post(
        server_url,
        "/paint",
        {"x1": 10, "y1": 10, "x2": 22, "y2": 22, "rgb": [0, 255, 0], "sigma": 1.2},
    )
    assert not np.allclose(before, np.asarray(st["z"]))


# --- what the port adds --------------------------------------------------------

SCRIPT = [
    ("/infer", {"index": 3}),
    ("/paint", {"x1": 10, "y1": 10, "x2": 22, "y2": 22, "rgb": [255, 0, 0]}),
    ("/paint", {"x1": 30, "y1": 5, "x2": 50, "y2": 25, "rgb": [0, 255, 0], "sigma": 1.2}),
    ("/scroll", {"x1": 8, "y1": 8, "x2": 16, "y2": 16, "direction": 1}),
    ("/latent_paint", {"x1": 20, "y1": 4, "x2": 44, "y2": 12, "value": 0.8}),
    ("/paint", {"x1": 0, "y1": 40, "x2": 12, "y2": 64, "rgb": [0, 0, 255]}),
    ("/undo", {}),
    ("/sample", {"seed": 4}),
    ("/reset", {}),
    ("/paint", {"x1": 20, "y1": 20, "x2": 40, "y2": 36, "rgb": [200, 120, 40], "sigma": 0.5}),
]


def test_scripted_service_matches_npe_tpu():
    """The same routes on the port's and on npe_tpu's EditorService (tiny
    profile, CPU, the same weights): the same latents at the golden
    tolerance, photos under the uint8-step rule. /sample draws from another
    generator in each package, so there only its shape and state count."""
    from npe_tpu.editor.engine import EditSession as JaxSession
    from npe_tpu.editor.web import EditorService as JaxService
    from npe_tpu_torch.editor.engine import EditSession

    js = JaxSession(config=tp.TINY_JAX, variables=tp.jax_variables(tp.TINY_JAX), dim=DIM, use_pallas=False)
    ts = EditSession(config=tp.TINY_TORCH, variables=tp.port_variables(tp.TINY_JAX), dim=DIM, device="cpu")
    jsv, tsv = JaxService(js), EditorService(ts)
    for route, body in SCRIPT:
        got, want = tsv.handle(route, dict(body)), jsv.handle(route, dict(body))
        assert (got["sample_flag"], got["session"], got["sessions"]) == (
            want["sample_flag"], want["session"], want["sessions"]), route
        assert np.asarray(got["z"]).shape == DIM
        np.testing.assert_array_equal(_photo(got), ts.im_uint8().transpose(1, 2, 0))
        if route == "/sample":
            continue
        tp.assert_close(np.asarray(got["z"]), np.asarray(want["z"]))
        tp.assert_im_close(ts.IM, js.IM, ts.RECON, js.RECON)
        # IM within the rule moves a truncated uint8 pixel by at most one step
        assert np.abs(_photo(got).astype(int) - js.im_uint8().transpose(1, 2, 0)).max() <= 1, route
    assert np.abs(ts.DELTA).max() > 1e-2  # the strokes really moved the image


@pytest.mark.parametrize("shape", [(64, 64, 3), (1, 1, 3), (7, 13, 3), (64, 160, 3)])
def test_png_writer_decodes_through_pil_to_the_input(shape):
    Image = pytest.importorskip("PIL.Image")
    import io

    a = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    data = encode_rgb(a)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), a)
    np.testing.assert_array_equal(decode_rgb(data), a)


def test_png_writer_refuses_other_arrays():
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8)):
        with pytest.raises(ValueError):
            encode_rgb(bad)
    data = bytearray(encode_rgb(np.zeros((2, 2, 3), np.uint8)))
    data[20] ^= 1  # inside IHDR
    with pytest.raises(ValueError, match="CRC"):
        decode_rgb(bytes(data))


def test_serve_checks_the_latent_grid_and_the_device(weights_file):
    with pytest.raises(ValueError, match="latent grid"):
        serve(config=tp.TINY_TORCH, weights_path=weights_file, port=0, device="cpu")  # (10, 10): 100 cells
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve(config=tp.TINY_TORCH, weights_path=weights_file, port=0, dim=DIM)
