"""Browser frontend for the Neural Photo Editor (npe_tpu `editor/web.py`).

The editor over HTTP: an HTML canvas pair (256x256 photo, the latent grid at
16 px a cell), brush size / colour / feather controls, and the Sample /
Reset / Update / Infer / Undo buttons, all backed by the headless
`EditSession`. Every handler is a plain JSON endpoint, so the whole editor
can be driven (and tested) with curl.

Endpoints (all POST bodies JSON; responses carry base64 PNGs + the latent
grid):
    GET  /            editor page
    GET  /state       current photo + latents
    POST /paint       {x1,y1,x2,y2,rgb:[r,g,b]}        brush stroke
    POST /scroll      {x1,y1,x2,y2,direction}          lighten/darken
    POST /latents     {grid: [[...]]}                  set the whole grid
    POST /latent_paint {x1,y1,x2,y2,value}             free-form brush on the
                      latent canvas; Z = per-cell mean pooling of the
                      painted canvas (reference `NPE.py:277-302`)
    POST /latent_cell {i,j,value}                      set one cell
    POST /undo        {}                               revert the last edit
    POST /sample      {seed?}                          Z ~ N(0,1)
    POST /reset       {}
    POST /update_gim  {}
    POST /infer       {index?}                         load validation image
    POST /session     {name}                           switch to (forking if
                      new) a named editing session; forks share the
                      weights, state is per-session
    POST /session_close {name?}                        drop a session

/paint and /scroll accept an optional "sigma" (soft-brush feather; 0 = hard
box, the reference's gk localizer as a runtime knob).

The PNGs are written by `utils/png.py` from the standard library: no imaging
package is needed.

Run: python -m npe_tpu_torch.editor.web --weights IAN_simple.npz --port 8000
     (add --device cpu to run without a GPU)
"""

import argparse
import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from npe_tpu_torch.editor.engine import EditSession
from npe_tpu_torch.utils.png import encode_rgb
from npe_tpu_torch.utils.ranges import to_tanh

_PAGE = """<!doctype html>
<html><head><title>Neural Photo Editor</title><style>
body{font-family:sans-serif;background:#1b1b1f;color:#ddd;display:flex;
flex-direction:column;align-items:center;gap:12px;padding:16px}
canvas{image-rendering:pixelated;border:1px solid #555}
#controls{display:flex;gap:8px;align-items:center}
button{background:#333;color:#ddd;border:1px solid #666;padding:6px 10px;
border-radius:4px;cursor:pointer}
</style></head><body>
<h3>Neural Photo Editor</h3>
<canvas id="photo" width="256" height="256"></canvas>
<canvas id="latent" width="160" height="160"></canvas>
<div id="controls">
<label>brush <input type="range" id="size" min="1" max="64" value="12"></label>
<label>feather <input type="range" id="feather" min="0" max="20" value="0"></label>
<input type="color" id="color" value="#ff0000">
<label>latent <input type="range" id="lval" min="-255" max="255" value="0"></label>
<select id="sess" onchange="post('/session',{name:this.value})"></select>
<button onclick="post('/session',{name:prompt('session name','img2')})">+</button>
<button onclick="post('/undo',{})">Undo</button>
<button onclick="post('/sample',{})">Sample</button>
<button onclick="post('/reset',{})">Reset</button>
<button onclick="post('/update_gim',{})">Update</button>
<input id="idx" size="5" value="420"><button onclick="infer()">Infer</button>
</div>
<script>
const photo=document.getElementById('photo'),latent=document.getElementById('latent');
let painting=false;
async function post(url,body){
  const r=await fetch(url,{method:'POST',body:JSON.stringify(body)});
  draw(await r.json());
}
function draw(st){
  for(const[id,key]of[['photo','photo_png'],['latent','latent_png']]){
    const img=new Image();
    img.onload=()=>document.getElementById(id).getContext('2d').drawImage(img,0,0,
      id==='photo'?256:160,id==='photo'?256:160);
    img.src='data:image/png;base64,'+st[key];
  }
  const sel=document.getElementById('sess');
  sel.innerHTML=(st.sessions||['main']).map(
    n=>`<option${n===st.session?' selected':''}>${n}</option>`).join('');
}
function feather(){return document.getElementById('feather').value/10;}
function box(e,c){const r=c.getBoundingClientRect();
  const x=Math.floor((e.clientX-r.left)/4),y=Math.floor((e.clientY-r.top)/4);
  const w=Math.floor(document.getElementById('size').value/4)+1;
  const x1=Math.max(Math.min(x-(w>>1),64-w),0),y1=Math.max(Math.min(y-(w>>1),64-w),0);
  return[x1,y1,x1+w,y1+w];}
function rgb(){const h=document.getElementById('color').value;
  return[parseInt(h.substr(1,2),16),parseInt(h.substr(3,2),16),parseInt(h.substr(5,2),16)];}
photo.addEventListener('mousedown',()=>painting=true);
window.addEventListener('mouseup',()=>painting=false);
photo.addEventListener('mousemove',e=>{if(!painting)return;
  const[x1,y1,x2,y2]=box(e,photo);
  post('/paint',{x1,y1,x2,y2,rgb:rgb(),sigma:feather()});});
photo.addEventListener('wheel',e=>{e.preventDefault();
  const[x1,y1,x2,y2]=box(e,photo);
  post('/scroll',{x1,y1,x2,y2,direction:e.deltaY<0?1:-1,sigma:feather()});});
function latentPaint(e){
  const r=latent.getBoundingClientRect();
  const x=e.clientX-r.left,y=e.clientY-r.top;
  const d=Math.max(2,Math.floor(document.getElementById('size').value/4));
  post('/latent_paint',{x1:x-d,y1:y-d,x2:x+d,y2:y+d,
    value:document.getElementById('lval').value/255});}
latent.addEventListener('mousemove',e=>{if(painting)latentPaint(e);});
latent.addEventListener('mousedown',e=>{painting=true;latentPaint(e);});
function infer(){post('/infer',{index:parseInt(document.getElementById('idx').value)})}
fetch('/state').then(r=>r.json()).then(draw);
</script></body></html>"""

def _png_b64(arr_u8_hwc):
    return base64.b64encode(encode_rgb(arr_u8_hwc)).decode()


class EditorService:
    """JSON-level editor operations over an EditSession (thread-safe)."""

    RES = 16  # canvas px per latent cell (160x160 canvas for a 10x10 grid)

    def __init__(self, session, valid=None):
        # Named sessions (multi-image editing). Forks share the first
        # session's weights (EditSession.fork), so opening another image
        # costs state only.
        self.sessions = {"main": session}
        self.active = "main"
        self.valid = valid
        self.lock = threading.Lock()
        self._fallback_ds = None

    @property
    def session(self):
        return self.sessions[self.active]

    def _latent_paint(self, body):
        """Free-form latent painting (reference `NPE.py:277-302`): fill the
        brush rect on the canvas mirror, then Z = per-cell mean of the
        painted canvas. The mirror is re-tiled from Z before each event (the
        reference's update_canvas runs after every operation, so the canvas
        never carries sub-cell state between events)."""
        s = self.session
        zg = np.asarray(s.Z_grid, np.float32)
        r = np.repeat(np.repeat(zg, self.RES, 0), self.RES, 1)
        y1 = max(int(body["y1"]), 0)
        y2 = min(int(body["y2"]), r.shape[0])
        x1 = max(int(body["x1"]), 0)
        x2 = min(int(body["x2"]), r.shape[1])
        if y2 > y1 and x2 > x1:
            r[y1:y2, x1:x2] = float(body["value"])
        pooled = r.reshape(zg.shape[0], self.RES, zg.shape[1], self.RES).mean(axis=(1, 3))
        s.set_latents(pooled)

    def state(self):
        s = self.session
        photo = s.im_uint8().transpose(1, 2, 0)
        zg = s.Z_grid
        # latent canvas: signed red/blue scale like the reference (`NPE.py:32`)
        v = np.clip(zg, -1, 1)
        lat = np.zeros((*zg.shape, 3), np.uint8)
        lat[..., 0] = np.uint8(255 - np.clip(-v, 0, 1) * 255)
        lat[..., 1] = np.uint8(255 - np.abs(v) * 255)
        lat[..., 2] = np.uint8(255 - np.clip(v, 0, 1) * 255)
        return {
            "photo_png": _png_b64(photo),
            "latent_png": _png_b64(np.repeat(np.repeat(lat, self.RES, 0), self.RES, 1)),
            "z": zg.tolist(),
            "sample_flag": bool(s.sample_flag),
            "session": self.active,
            "sessions": sorted(self.sessions),
        }

    def handle(self, route, body):
        with self.lock:
            s = self.session
            if route == "/paint":
                s.paint_stroke(
                    body["x1"], body["y1"], body["x2"], body["y2"], body["rgb"],
                    sigma=float(body.get("sigma", 0.0)),
                )
            elif route == "/scroll":
                s.scroll_patch(
                    body["x1"], body["y1"], body["x2"], body["y2"], body["direction"],
                    sigma=float(body.get("sigma", 0.0)),
                )
            elif route == "/session":
                # switch to (creating if needed) a named session
                name = str(body["name"])
                if name not in self.sessions:
                    self.sessions[name] = s.fork()
                self.active = name
            elif route == "/session_close":
                name = str(body.get("name", self.active))
                if name in self.sessions and len(self.sessions) > 1:
                    del self.sessions[name]
                    if self.active == name:
                        self.active = sorted(self.sessions)[0]
            elif route == "/latents":
                s.set_latents(np.asarray(body["grid"], np.float32))
            elif route == "/latent_paint":
                self._latent_paint(body)
            elif route == "/latent_cell":
                zg = s.Z_grid.copy()
                zg[int(body["i"]), int(body["j"])] = float(body["value"])
                s.set_latents(zg)
            elif route == "/undo":
                s.undo()  # no-op when the stack is empty
            elif route == "/sample":
                s.sample(int(body.get("seed", np.random.randint(1 << 31))))
            elif route == "/reset":
                s.reset()
            elif route == "/update_gim":
                s.update_gim()
            elif route == "/infer":
                idx = int(body.get("index", 420))
                if self.valid is not None:
                    s.infer(to_tanh(np.float32(self.valid[idx % len(self.valid)])))
                else:
                    if self._fallback_ds is None:
                        from npe_tpu_torch.data import SyntheticFaces

                        self._fallback_ds = SyntheticFaces(num_examples=4096)
                    s.infer(to_tanh(np.float32(self._fallback_ds.get_data([idx])[0])))
            else:
                raise KeyError(route)
            return self.state()


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/":
                data = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/state":
                self._json(service.state())
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            try:
                self._json(service.handle(self.path, body))
            except KeyError:
                self._json({"error": f"unknown route {self.path}"}, 404)
            except Exception as e:  # surface errors to the client
                self._json({"error": str(e)}, 500)

    return Handler


def serve(config="IAN_simple", weights_path=None, valid_npz=None, port=8000, host="127.0.0.1",
          device="cuda", head_mode=None, mdblock_mode=None, dim=(10, 10)):
    """An editor over a new EditSession, loaded with validation image 420
    (or the procedural face of that index): returns the ThreadingHTTPServer
    (serve_forever on the caller's schedule). dim: the latent grid, whose
    cells hold the model's latents."""
    session = EditSession(config=config, weights_path=weights_path, dim=dim, device=device,
                          head_mode=head_mode, mdblock_mode=mdblock_mode)
    valid = None
    if valid_npz:
        try:
            valid = np.load(valid_npz)["arr_0"]
        except (FileNotFoundError, KeyError):
            pass
    service = EditorService(session, valid)
    service.handle("/infer", {"index": 420})
    server = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"Neural Photo Editor at http://{host}:{server.server_address[1]}/", flush=True)
    return server


def main(argv=None):
    p = argparse.ArgumentParser(description="npe_tpu_torch Neural Photo Editor in the browser")
    p.add_argument("--config", default="IAN_simple")
    p.add_argument("--weights", default=None)
    p.add_argument("--valid", default=None)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--head-mode", default=None, help="the RGB-Beta head's form: plain, hybrid or fused")
    p.add_argument("--mdblock-mode", default=None, help="the MDBLOCKs' form: plain or fused")
    p.add_argument("--dim", type=int, nargs=2, default=(10, 10), metavar=("ROWS", "COLS"),
                   help="the latent grid (rows x cols = the model's latents)")
    a = p.parse_args(argv)
    server = serve(a.config, a.weights, a.valid, a.port, device=a.device, head_mode=a.head_mode,
                   mdblock_mode=a.mdblock_mode, dim=tuple(a.dim))
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
