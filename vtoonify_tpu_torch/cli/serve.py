"""HTTP server over the port's Model API (port of examples/serve.py, the
executable counterpart of the reference's Gradio/HF-Spaces demo, reference
vtoonify_model.py:25-279 as mounted by its Space).

No extra dependencies: a stdlib http.server app with a small HTML page (file
upload + style/degree controls posting raw image bytes). `--gradio` mounts
the same Model in a gradio Blocks UI instead (gradio is imported only then).
Requests run concurrently on threads that share ONE `Model` (its cached
pipelines and its landmarker), with no lock around it, as in the JAX
package's server. Where that server starts a thread per request, this one
keeps a fixed pool of long-lived worker threads (`PooledHTTPServer`): torch
caches cuDNN's execution plans per thread, so a request on a new thread
rebuilds them all (PERF.md). The model runs on the card unless --cpu.

Usage:
    python -m vtoonify_tpu_torch.cli.serve --checkpoint_root ./checkpoint [--port 7860]
    curl -s -X POST --data-binary @face.jpg \
        'localhost:7860/toonify?style_type=cartoon1&style_degree=0.5' > out.jpg

Endpoints:
    GET  /            HTML demo page
    GET  /styles      JSON list of registry styles
    POST /toonify     raw image bytes -> toonified JPEG
                      query: style_type, style_degree, color_transfer=0|1
    Errors: 400 (bad query, empty or undecodable body), 404 (unknown path,
    or a registry style whose checkpoints are not installed), 422 (no face
    found), 500 (anything else, as text).
"""

from __future__ import annotations

import argparse
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

_PAGE = """<!doctype html><meta charset="utf-8"><title>VToonify demo</title>
<style>body{font-family:sans-serif;max-width:720px;margin:2em auto}
img{max-width:100%}</style>
<h2>VToonify demo</h2>
<p>Portrait image &rarr; stylized 4&times; output. One style code per image
(computed from the aligned face), synthesis on the GPU.</p>
<input type=file id=f accept="image/*">
<select id=s>%OPTIONS%</select>
<label>degree <input type=range id=d min=0 max=1 step=0.1 value=0.5></label>
<label><input type=checkbox id=c> color transfer</label>
<button onclick=go()>Toonify</button>
<p id=msg></p><img id=out>
<script>
async function go(){
  const f=document.getElementById('f').files[0];
  if(!f){document.getElementById('msg').textContent='pick an image';return}
  document.getElementById('msg').textContent='processing…';
  const q=new URLSearchParams({style_type:document.getElementById('s').value,
    style_degree:document.getElementById('d').value,
    color_transfer:document.getElementById('c').checked?'1':'0'});
  const r=await fetch('/toonify?'+q,{method:'POST',body:f});
  if(!r.ok){document.getElementById('msg').textContent=await r.text();return}
  document.getElementById('out').src=URL.createObjectURL(await r.blob());
  document.getElementById('msg').textContent='done';
}
</script>"""


def make_handler(model, default_style: str):
    """Build the request handler bound to a loaded Model."""
    import cv2
    import numpy as np

    from vtoonify_tpu_torch.pipeline.model_api import STYLE_TYPES

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="text/plain"):
            if isinstance(body, str):
                body = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/":
                opts = "".join(
                    f'<option value="{k}"'
                    + (" selected" if k == default_style else "")
                    + f">{k}</option>"
                    for k in STYLE_TYPES
                )
                self._send(200, _PAGE.replace("%OPTIONS%", opts),
                           "text/html; charset=utf-8")
            elif path == "/styles":
                self._send(200, json.dumps(sorted(STYLE_TYPES)),
                           "application/json")
            else:
                self._send(404, "not found")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/toonify":
                self._send(404, "not found")
                return
            # drain the body FIRST: replying (even an error) while the
            # client is still streaming the upload breaks the connection
            # (client-side EPIPE) instead of delivering the status
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n > 0 else b""
            q = parse_qs(url.query)
            style = q.get("style_type", [default_style])[0]
            try:
                degree = float(q.get("style_degree", ["0.5"])[0])
            except ValueError:
                self._send(400, "style_degree must be a number")
                return
            color = q.get("color_transfer", ["0"])[0] in ("1", "true")
            if style not in STYLE_TYPES:
                self._send(400, f"unknown style_type {style!r}")
                return
            if not raw:
                self._send(400, "empty body — POST raw image bytes")
                return
            buf = np.frombuffer(raw, np.uint8)
            bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            if bgr is None:
                self._send(400, "could not decode image")
                return
            try:
                frame, aligned, msg = model.detect_and_align_frame(
                    cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
                if frame is None:
                    self._send(422, msg)
                    return
                out = model.image_toonify(frame, aligned,
                                          style_degree=degree,
                                          style_type=style,
                                          color_transfer=color)
            except FileNotFoundError as e:
                # registry lists every released style; only the installed
                # ones have checkpoints on disk
                self._send(404, f"style {style!r} not installed: {e}")
                return
            except Exception as e:  # keep the connection HTTP-shaped
                self._send(500, f"{type(e).__name__}: {e}")
                return
            ok, enc = cv2.imencode(".jpg",
                                   cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
            if not ok:
                self._send(500, "encode failed")
                return
            self._send(200, enc.tobytes(), "image/jpeg")

    return Handler


class PooledHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose requests run on `workers` long-lived
    threads: a thread keeps torch's per-thread caches (cuDNN's execution
    plans) from one request to the next. More concurrent requests than
    workers wait in the pool's queue."""

    workers = 4

    def __init__(self, address, handler):
        super().__init__(address, handler)
        self._pool = ThreadPoolExecutor(self.workers, thread_name_prefix="serve")

    def process_request(self, request, client_address):
        self._pool.submit(self.process_request_thread, request, client_address)

    def server_close(self):
        super().server_close()
        self._pool.shutdown(wait=True)


def build_server(model, host: str, port: int,
                 default_style: str = "cartoon1") -> PooledHTTPServer:
    return PooledHTTPServer((host, port), make_handler(model, default_style))


def serve_forever_in_thread(server) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def _gradio_app(model, default_style: str):
    import gradio as gr  # optional dependency

    from vtoonify_tpu_torch.pipeline.model_api import STYLE_TYPES

    def run(img_path, style, degree, color):
        frame, aligned, msg = model.detect_and_align_image(img_path)
        if frame is None:
            raise gr.Error(msg)
        return model.image_toonify(frame, aligned, style_degree=degree,
                                   style_type=style, color_transfer=color)

    with gr.Blocks(title="VToonify") as demo:
        gr.Markdown("## VToonify demo")
        with gr.Row():
            inp = gr.Image(type="filepath", label="portrait")
            out = gr.Image(label="stylized")
        style = gr.Dropdown(sorted(STYLE_TYPES), value=default_style,
                            label="style")
        degree = gr.Slider(0.0, 1.0, 0.5, step=0.1, label="style degree")
        color = gr.Checkbox(False, label="color transfer")
        gr.Button("Toonify").click(run, [inp, style, degree, color], out)
    return demo


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint_root", type=str, default="./checkpoint")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--style_type", type=str, default="cartoon1",
                   help="default style preselected in the UI")
    p.add_argument("--landmarks", type=str, default=None,
                   help="precomputed 68-point landmarks .npy (dlib-free)")
    p.add_argument("--cpu", action="store_true",
                   help="run the model on the CPU instead of the card")
    p.add_argument("--gradio", action="store_true",
                   help="mount a gradio UI instead of the stdlib server "
                        "(requires gradio to be installed)")
    args = p.parse_args(argv)

    from vtoonify_tpu_torch.pipeline.model_api import Model

    # Model/StaticLandmarker accept an .npy path directly
    model = Model(checkpoint_root=args.checkpoint_root,
                  landmarks=args.landmarks, device="cpu" if args.cpu else None)

    if args.gradio:
        _gradio_app(model, args.style_type).launch(
            server_name=args.host, server_port=args.port
        )
        return

    server = build_server(model, args.host, args.port, args.style_type)
    print(f"serving on http://{args.host}:{args.port}  "
          f"(checkpoints: {args.checkpoint_root})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
