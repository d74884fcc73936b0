"""Inference HTTP server (port of `vosesam_tpu/serve/server.py`).

Reference: text_server.py is a Flask skeleton whose route bodies are
placeholder comments (:36-58, :68, SURVEY.md §2.11). This one serves, with
the standard library only:

  GET  /health                 -> {"status": "ok", "backend": "cuda" | "cpu",
                                   "device": the card's name or "cpu"}
  POST /segment   {"image": b64 png/jpg, "points": [[x,y]...],
                   "labels": [1,0,...]}          -> {"mask": b64 png, "shape"}
  POST /track     {"frames": [b64...], "template_mask": b64 indexed png,
                   "chunk": 8}   -> {"masks": [b64 indexed png ...], "scores"}
  POST /inpaint   {"frames": [b64...], "masks": [b64 indexed png ...],
                   "dilate_radius": 15, "ratio": 1.0}
                                 -> {"frames": [b64 png ...]}
                  (503 unless the model holds an E2FGVI inpainter —
                  TrackingAnything(e2fgvi_checkpoint=...))

Images travel base64 and go through the port's own codecs
(`eval/codec.py`: PNG in memory, JPEG through its JPEG route); masks come
back as palette PNGs with the PASCAL colormap.

Concurrency: inference routes are single-flight — one model, one device,
one request at a time. A request arriving while another is in flight gets
an immediate ``503 {"error": "busy"}`` with a ``Retry-After`` header
instead of queueing behind the lock; clients retry with backoff. The lock
is released before the reply is written, so a request sent as soon as the
previous reply was read is not refused. /health is always served. An exception inside a route answers 500 with its name and
message (and its traceback on stderr).

    python -m vosesam_tpu_torch.serve.server --port 6080 \
        [--sam_checkpoint PATH] [--xmem_checkpoint PATH] [--device cpu]
"""

from __future__ import annotations

import base64
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np
import torch

from vosesam_tpu_torch.eval import codec
from vosesam_tpu_torch.eval.palette import pascal_colormap


def _decode_image(b64: str) -> np.ndarray:
    return codec.decode_rgb(base64.b64decode(b64))


def _decode_mask(b64: str) -> np.ndarray:
    return codec.decode_indices(base64.b64decode(b64))


def _encode_mask(mask: np.ndarray) -> str:
    data = codec.encode_png_palette(np.asarray(mask).astype(np.uint8), pascal_colormap())
    return base64.b64encode(data).decode()


def _encode_frame(frame: np.ndarray) -> str:
    return base64.b64encode(codec.encode_png_rgb(np.asarray(frame, np.uint8))).decode()


class InferenceHandler(BaseHTTPRequestHandler):
    """The routes. `serve` makes a subclass per server that holds its model
    and its single-flight lock."""

    model = None
    lock: threading.Lock

    def _json(self, code: int, payload: dict, retry_after: Optional[int] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        if self.path == "/health":
            dev = self.model.device
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            self._json(200, {"status": "ok", "backend": dev.type, "device": name})
        else:
            self._json(404, {"error": "unknown route"})

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, UnicodeDecodeError) as e:
            self._json(400, {"error": f"bad json: {e}"})
            return

        route = {"/segment": self._segment, "/track": self._track,
                 "/inpaint": self._inpaint}.get(self.path)
        if route is None:
            self._json(404, {"error": "unknown route"})
            return
        # single-flight: refuse at once when busy rather than queueing
        if not self.lock.acquire(blocking=False):
            self._json(503, {"error": "busy: another inference request is in flight"},
                       retry_after=1)
            return
        try:
            code, payload = route(req)
        except Exception as e:  # the server keeps serving; the client gets the error
            traceback.print_exc()
            code, payload = 500, {"error": f"{type(e).__name__}: {e}"}
        finally:
            self.lock.release()
        # written after the release: a client that sends its next request as
        # soon as it has read this reply finds the lock free
        self._json(code, payload)

    def _segment(self, req: dict) -> Tuple[int, dict]:
        image = _decode_image(req["image"])
        points = np.asarray(req.get("points", []), np.float32).reshape(-1, 2)
        labels = np.asarray(req.get("labels", [1] * len(points)), np.int32)
        self.model.samcontroler.reset_image()
        mask, _logit, _painted = self.model.first_frame_click(image, points, labels)
        return 200, {"mask": _encode_mask(mask.astype(np.uint8)), "shape": list(mask.shape)}

    def _inpaint(self, req: dict) -> Tuple[int, dict]:
        if getattr(self.model, "baseinpainter", None) is None:
            return 503, {"error": "inpainter not loaded — start the model with "
                                  "e2fgvi_checkpoint=..."}
        frames = [_decode_image(b) for b in req["frames"]]
        masks = [_decode_mask(b) for b in req["masks"]]
        dilate = req.get("dilate_radius")
        out = self.model.baseinpainter.inpaint(
            frames, masks, ratio=float(req.get("ratio", 1.0)),
            dilate_radius=None if dilate is None else int(dilate))
        return 200, {"frames": [_encode_frame(f) for f in out]}

    def _track(self, req: dict) -> Tuple[int, dict]:
        frames = [_decode_image(b) for b in req["frames"]]
        template = _decode_mask(req["template_mask"])
        self.model.xmem.clear_memory()
        # "chunk" <= 1 runs the per-frame generator
        chunk = int(req.get("chunk", 8))
        if chunk > 1:
            masks, scores = self.model.generator_chunked(frames, template, chunk=chunk)
        else:
            masks, _logits, _painted, scores = self.model.generator(frames, template)
        return 200, {"masks": [_encode_mask(m) for m in masks],
                     "scores": [list(map(float, s)) for s in scores]}


def serve(model, host: str = "127.0.0.1", port: int = 6080) -> ThreadingHTTPServer:
    """Start serving `model` on a daemon thread (non-blocking); returns the
    server (`port=0` picks a free port: `server_address[1]`). Stop it with
    `shutdown()` and `server_close()`."""
    handler = type("Handler", (InferenceHandler,), {"model": model, "lock": threading.Lock()})
    httpd = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv=None) -> None:
    import argparse

    from vosesam_tpu_torch.config import FrameworkConfig
    from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

    ap = argparse.ArgumentParser(description="The port's inference HTTP server")
    ap.add_argument("--port", type=int, default=6080)
    ap.add_argument("--sam_checkpoint", default=None)
    ap.add_argument("--xmem_checkpoint", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    model = TrackingAnything(sam_checkpoint=args.sam_checkpoint,
                             xmem_checkpoint=args.xmem_checkpoint,
                             cfg=FrameworkConfig(), device=args.device)
    httpd = serve(model, port=args.port)
    print(f"serving on :{args.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
