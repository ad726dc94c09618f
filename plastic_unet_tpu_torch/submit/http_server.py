"""HTTP serving endpoint for mask prediction (counterpart of
plastic_unet_tpu.submit.http_server), standard library only
(ThreadingHTTPServer) around submit.server.MaskPredictor:

  GET  /healthz       -> {"status": "ok", "device": ...}: the predictor's
                         torch device and, on CUDA, the card's name
  POST /predict       -> body: .npy (N, H, W[, 1]) float array;
                         response: .npy (N, nbf, nbf) float32 masks
  POST /predict_rle   -> body: .npy as above; response: JSON list of RLE
                         strings (the predictor needs a threshold)

Any error answers 400 with its message, an unknown path 404. Requests run
one at a time through a lock (one device) while the IO threads overlap.

    python -m plastic_unet_tpu_torch.submit.http_server --model out/train_net.pth [--device cpu]
    python -m plastic_unet_tpu_torch.submit.http_server --artifact out/artifact [--device cpu]

``--artifact`` serves an exported artifact (submit.export, written by
cli.export_model) on ``--device``. The artifact bakes in the views, the
threshold, the chunk and the model's shape, so ``--tta``, ``--threshold``,
``--chunk``, ``--nbf``, ``--neurons`` and ``--prule`` are rejected with it,
as the JAX server rejects them.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def device_label(device: torch.device) -> str:
    """The predictor's device as /healthz reports it, with the card's name on CUDA."""
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def make_handler(predictor, lock: threading.Lock):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                payload = json.dumps({"status": "ok", "device": device_label(predictor.device)}).encode()
                self._send(200, payload, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path not in ("/predict", "/predict_rle"):
                self._send(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                arr = np.load(io.BytesIO(self.rfile.read(length)), allow_pickle=False)
                with lock:
                    if self.path == "/predict":
                        preds = predictor.predict(arr).astype(np.float32)
                        buf = io.BytesIO()
                        np.save(buf, preds, allow_pickle=False)
                        self._send(200, buf.getvalue(), "application/octet-stream")
                    else:
                        rles = predictor.predict_rle(arr)
                        self._send(200, json.dumps(rles).encode(), "application/json")
            except Exception as e:  # noqa: BLE001 -- the server keeps running; the client reads the error
                self._send(400, str(e).encode(), "text/plain")

    return Handler


def serve(predictor, host: str = "127.0.0.1", port: int = 8600, *, block: bool = True):
    """Warm the predictor up, then serve. Returns the server; with
    ``block=False`` it serves from a daemon thread and the caller owns
    ``shutdown()`` and ``server_close()``."""
    predictor.warmup()
    server = ThreadingHTTPServer((host, port), make_handler(predictor, threading.Lock()))
    if block:
        print(f"serving mask prediction on http://{host}:{port}")
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description="Serve plastic U-Net mask prediction over HTTP")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help=".pth checkpoint (reference format)")
    src.add_argument("--artifact", help="exported serving artifact directory (cli.export_model); the "
                     "model-shape/tta/threshold/chunk flags are baked into the artifact and rejected here")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8600, type=int)
    p.add_argument("--nbf", default=101, type=int)
    p.add_argument("--neurons", default=16, type=int)
    p.add_argument("--prule", default="hebb")
    p.add_argument("--tta", default="identity", help="preset tta2/tta4/tta8 or comma list of dihedral views")
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--chunk", default=128, type=int)
    p.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.artifact:
        # Serving something other than what was asked for (probabilities where a threshold was
        # passed) would be silent; the JAX server rejects these flags too.
        baked = ("tta", "threshold", "chunk", "nbf", "neurons", "prule")
        passed = [f for f in baked if getattr(args, f) != parser.get_default(f)]
        if passed:
            parser.error("--artifact serves the exported configuration; " + ", ".join("--" + f for f in passed)
                         + " cannot be overridden (re-export with cli.export_model)")
        from plastic_unet_tpu_torch.submit.export import load_predictor

        predictor = load_predictor(args.artifact, device=args.device)
    else:
        from plastic_unet_tpu_torch.ops.augment import parse_tta
        from plastic_unet_tpu_torch.submit.server import MaskPredictor

        predictor = MaskPredictor.from_pth(args.model, nbf=args.nbf, neurons=args.neurons, rule=args.prule,
                                           tta=parse_tta(args.tta), threshold=args.threshold, chunk=args.chunk,
                                           device=args.device)
    serve(predictor, args.host, args.port)


if __name__ == "__main__":
    main()
