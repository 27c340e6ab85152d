"""Interactive demo server (layoutllm_t2i_tpu/cli/demo.py; reference
GLIGEN/demo/app.py).

Stdlib-only HTTP app with the reference demo's interaction model: draw
grounding boxes on a canvas with the mouse, label each box, set guidance
scale / alpha schedule / negative prompt / seed, and generate. POST
/api/generate takes the page's JSON and answers {"image": base64 PNG,
"layout": [...], "seconds": s} or {"error": "..."}. An uploaded image to
inpaint ("inpaint": a data URL) must be an 8-bit RGB PNG at the generation
size, read without Pillow (utils/images.py read_png; the JAX demo resizes
any image with Pillow); the boxes are the region to paint. Any other
upload gets the error.

Run: python -m layoutllm_t2i_torch.cli.demo [--ckpt c.pth | --small] [--port 7860]
then open http://localhost:7860. The model runs on the card unless
--device says otherwise (--small --device cpu for a CPU smoke).
"""
from __future__ import annotations

import argparse
import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

_PAGE = """<!doctype html>
<html><head><title>layoutllm_t2i_torch demo</title>
<style>
body{font-family:sans-serif;max-width:1100px;margin:1.5em auto;display:flex;gap:2em}
#left{width:540px}#right{flex:1}
canvas{border:1px solid #888;cursor:crosshair;background:#fafafa}
input,textarea,select{width:100%;margin:3px 0;box-sizing:border-box}
label{font-size:13px;color:#333}
button{margin:6px 4px 6px 0;padding:6px 14px}
#boxes li{font-size:13px}
img.result{max-width:512px;border:1px solid #ccc}
.row{display:flex;gap:8px}.row>div{flex:1}
#status{color:#06c;font-size:13px}
</style></head><body>
<div id="left">
<h2>Layout-grounded generation</h2>
<label>Prompt</label>
<input id="prompt" value="a dog chasing a frisbee in a park">
<label>Negative prompt (optional)</label>
<input id="negative" value="">
<label>Drag on the canvas to draw grounding boxes (you will be asked for a
label); boxes are also the inpaint region when an image is uploaded.</label>
<canvas id="cv" width="512" height="512"></canvas>
<div>
<button onclick="clearBoxes()">Clear boxes</button>
<button onclick="undoBox()">Undo</button>
<input type="file" id="inpaint" accept="image/*" style="width:auto">
</div>
<ol id="boxes"></ol>
<div class="row">
<div><label>Guidance scale</label><input id="guidance" type="number" value="7.5" step="0.5"></div>
<div><label>Alpha (on,decay,off)</label><input id="alpha" value="0.3,0.0,0.7"></div>
<div><label>Seed</label><input id="seed" type="number" value="42"></div>
</div>
<button onclick="generate()" id="go">Generate</button>
<span id="status"></span>
</div>
<div id="right"><h3>Result</h3><div id="out"></div></div>
<script>
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let boxes = [], drag = null, bgImage = null;
function redraw(){
  ctx.clearRect(0,0,512,512);
  if (bgImage) ctx.drawImage(bgImage,0,0,512,512);
  ctx.lineWidth = 2; ctx.font = '13px sans-serif';
  boxes.forEach((b,i)=>{
    ctx.strokeStyle = `hsl(${i*67%360},80%,40%)`;
    ctx.fillStyle = ctx.strokeStyle;
    ctx.strokeRect(b.x*512,b.y*512,b.w*512,b.h*512);
    ctx.fillText(b.label, b.x*512+3, b.y*512+14);
  });
  if (drag){ ctx.strokeStyle='#000'; ctx.setLineDash([4,3]);
    ctx.strokeRect(drag.x0,drag.y0,drag.x1-drag.x0,drag.y1-drag.y0);
    ctx.setLineDash([]); }
  document.getElementById('boxes').innerHTML = boxes.map(
    b=>`<li>${b.label}: [${b.x.toFixed(2)}, ${b.y.toFixed(2)}, ${b.w.toFixed(2)}, ${b.h.toFixed(2)}]</li>`).join('');
}
cv.onmousedown = e=>{const r=cv.getBoundingClientRect();
  drag={x0:e.clientX-r.left,y0:e.clientY-r.top,x1:e.clientX-r.left,y1:e.clientY-r.top};};
cv.onmousemove = e=>{if(!drag)return;const r=cv.getBoundingClientRect();
  drag.x1=e.clientX-r.left;drag.y1=e.clientY-r.top;redraw();};
cv.onmouseup = e=>{
  if(!drag)return;
  const x=Math.min(drag.x0,drag.x1)/512, y=Math.min(drag.y0,drag.y1)/512;
  const w=Math.abs(drag.x1-drag.x0)/512, h=Math.abs(drag.y1-drag.y0)/512;
  drag=null;
  if(w>0.02 && h>0.02){
    const label=prompt('Label for this box:','object');
    if(label) boxes.push({label,x,y,w,h});
  }
  redraw();};
function clearBoxes(){boxes=[];redraw();}
function undoBox(){boxes.pop();redraw();}
document.getElementById('inpaint').onchange = e=>{
  const f=e.target.files[0]; if(!f){bgImage=null;redraw();return;}
  const rd=new FileReader();
  rd.onload=()=>{const im=new Image();im.onload=()=>{bgImage=im;redraw();};
    im.src=rd.result; window._inpaintData=rd.result;};
  rd.readAsDataURL(f);};
async function generate(){
  const st=document.getElementById('status');
  st.textContent='generating… (first call compiles, may take minutes)';
  document.getElementById('go').disabled=true;
  const body={
    prompt: document.getElementById('prompt').value,
    negative: document.getElementById('negative').value,
    guidance: parseFloat(document.getElementById('guidance').value),
    alpha: document.getElementById('alpha').value.split(',').map(Number),
    seed: parseInt(document.getElementById('seed').value),
    boxes: boxes,
    inpaint: window._inpaintData || null,
  };
  try{
    const resp=await fetch('/api/generate',{method:'POST',
      headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
    const j=await resp.json();
    if(j.error){st.textContent='error: '+j.error;}
    else{
      document.getElementById('out').innerHTML =
        `<img class="result" src="data:image/png;base64,${j.image}">`+
        `<pre>${JSON.stringify(j.layout)}</pre>`;
      st.textContent=`done in ${j.seconds.toFixed(1)}s`;
    }
  }catch(err){st.textContent='request failed: '+err;}
  document.getElementById('go').disabled=false;
}
redraw();
</script>
</body></html>"""


def _generate(pipe, req):
    """JSON request -> (png_b64, layout, seconds)."""
    from ..pipeline.inference import InferencePipeline, images_to_uint8
    from ..pipeline.scene_graph import relation_texts_for_inference
    from ..utils.boxes import draw_boxes_ltrb
    from ..utils.images import png_bytes_uint8

    prompt = req.get("prompt", "")
    cats = [b["label"] for b in req.get("boxes", [])]
    boxes = [[b["x"], b["y"], b["x"] + b["w"], b["y"] + b["h"]]
             for b in req.get("boxes", [])]
    rel = relation_texts_for_inference(prompt, pipe.models.max_relas)
    seed = int(req.get("seed", 42))

    # per-request guidance/alpha: the pipeline itself when they match, else
    # a sibling pipeline on the same models (cached per setting)
    guidance = float(req.get("guidance", pipe.guidance_scale))
    alpha = tuple(req.get("alpha") or pipe.alpha_type)
    p = pipe
    if guidance != pipe.guidance_scale or alpha != pipe.alpha_type:
        key = (guidance, alpha)
        cache = getattr(pipe, "_demo_variants", None)
        if cache is None:
            cache = pipe._demo_variants = {}
        if key not in cache:
            cache[key] = InferencePipeline(
                pipe.models, steps=pipe.steps, sampler=pipe.sampler,
                guidance_scale=guidance, alpha_type=alpha)
        p = cache[key]

    cond = p.build_cond([prompt], [(boxes, cats)], [rel])
    if req.get("negative"):
        cond["uc_context"] = p.encode_text([req["negative"]])
    if req.get("inpaint"):
        cond.update(_inpaint_cond(p.models, req["inpaint"], boxes, seed))
    noise, gen = p._batch_noise(1, seed)
    t0 = time.perf_counter()
    imgs = p.sample_latents(cond, noise, gen).cpu().numpy()
    dt = time.perf_counter() - t0

    sample = draw_boxes_ltrb(images_to_uint8(imgs)[0], boxes, cats)
    layout = [{"label": c, "box_ltrb": [round(v, 3) for v in b]}
              for c, b in zip(cats, boxes)]
    return base64.b64encode(png_bytes_uint8(sample)).decode(), layout, dt


def _inpaint_cond(models, data_url: str, boxes, seed: int) -> dict:
    """A data URL's PNG as the blend's source (cli/gligen_inference.py
    inpaint_conditioning): it must be an 8-bit RGB PNG at the generation
    size."""
    from ..utils.images import read_png
    from .gligen_inference import (check_inpaint_size, generation_size,
                                   inpaint_conditioning)

    head, _, payload = data_url.partition(",")
    if not head.startswith("data:image/png"):
        raise ValueError("inpaint: want a PNG data URL (data:image/png;base64,...)")
    pixels = read_png(base64.b64decode(payload))
    size = generation_size(models.unet_cfg, models.vae_cfg)
    check_inpaint_size(pixels, size)
    return inpaint_conditioning(models, pixels, boxes, 1, seed)


def build_handler(pipe, lock):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._send(_PAGE.encode(), "text/html; charset=utf-8")

        def do_POST(self):
            if self.path != "/api/generate":
                self._send(b'{"error": "unknown endpoint"}',
                           "application/json", 404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length).decode())
                with lock:
                    b64, layout, dt = _generate(pipe, req)
                out = {"image": b64, "layout": layout, "seconds": dt}
            except Exception as e:  # surface errors to the UI
                out = {"error": f"{type(e).__name__}: {e}"}
            self._send(json.dumps(out).encode(), "application/json")

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the CUDA card")
    return ap.parse_args(argv)


def build_pipeline(args):
    from ..pipeline.inference import InferencePipeline
    from ..pipeline.loaders import load_models_from_gligen_ckpt, random_models

    models = (load_models_from_gligen_ckpt(args.ckpt, device=args.device)
              if args.ckpt else random_models(small=args.small,
                                              device=args.device))
    steps = min(args.steps, 8) if args.small else args.steps
    return InferencePipeline(models, steps=steps, sampler="plms",
                             guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7))


def build_server(args) -> HTTPServer:
    """The demo's HTTP server on (--host, --port; 0 picks a free port),
    not yet serving."""
    pipe = build_pipeline(args)
    return HTTPServer((args.host, args.port),
                      build_handler(pipe, threading.Lock()))


def main(argv=None):
    server = build_server(parse_args(argv))
    host, port = server.server_address[:2]
    print(f"demo listening on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
