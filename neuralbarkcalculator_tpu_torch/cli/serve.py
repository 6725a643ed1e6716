"""Online inference server of the PyTorch port: HTTP front end over the
batched engine.

Usage::

    python -m neuralbarkcalculator_tpu_torch.cli.serve MODEL.pt \
        [--device cuda|cpu] [--host 127.0.0.1] [--port 8642] \
        [--batch_size N] [--max_wait_ms MS] [--model fcn_resnet50] \
        [--fixed_height 1024] [--float32] [--int8] [--no_warmup]

Runs on the card by default (``--device cuda``) and raises when there is
none; ``--device cpu`` serves from the CPU.

Endpoints:

- ``POST /v1/predict``: body, the image bytes (PNG/BMP/JPEG; anything PIL
  decodes). The image goes through the folder preprocess on the host
  (resize to 1024 when larger, dark-band trim; reference models.py:191-201),
  is micro-batched with concurrent requests onto the device
  (pipeline/serving.py), postprocessed (native remove_small_zones), and
  answered per ``?format=``:

  - ``json`` (default): the final_stats.csv numbers for this image (bark
    and node percentages and mm^2 areas, reference models.py:323-332), the
    class pixel counts and the serving telemetry (queue and compute ms,
    batch size);
  - ``mask``: the dual PNG (L-mode, bark=127 node=255, models.py:349-356);
  - ``combined``: the side-by-side Input / Generated figure PNG (the
    port's compositor, pipeline/compositor.py).

  ``?exclude_nodes=1`` applies the node -> bark remap (models.py:273-276)
  to this request only; ``?dpi=N`` sets the combined figure's dpi.

- ``GET /healthz``: liveness, the model, the engine's device type and the
  CUDA device count.
- ``GET /v1/stats``: request counters, mean and largest batch, latency
  percentiles (p50 / p95 / max), queue depth.

One process per card. The stdlib ThreadingHTTPServer handles transport:
each request thread decodes, preprocesses on the host and blocks on its
future, while the one batcher thread makes every call into the engine.
Backpressure: a bounded queue answers 503 with Retry-After instead of
buffering without bound.

Over a ``(data, model)`` mesh of processes (a library API, no flag, as in
JAX): grid rank 0 calls ``make_server(args, mesh=mesh)`` and serves; every
other rank calls ``BatchingPredictor.follow(make_engine(args, mesh))``
with the same arguments (pipeline/serving.py).
"""
from __future__ import annotations

import argparse
import io
import json
import os
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..models.segmentation import MODEL_FACTORIES

MAX_BODY_BYTES = 256 << 20  # one 8192^2 RGB BMP is ~201 MB


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="bark calculator inference server (PyTorch / CUDA)")
    parser.add_argument("model_path", type=str,
                        help="reference .pt, flax .msgpack, or orbax dir, "
                             "or an offline int8 checkpoint (the port's "
                             "*.int8.pt or the JAX package's "
                             "*.int8.msgpack)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="serve from the CUDA card (default; fails "
                             "without one) or from the CPU")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8642)
    parser.add_argument("--model", type=str, default="fcn_resnet50",
                        choices=sorted(MODEL_FACTORIES))
    parser.add_argument("--batch_size", type=int, default=None,
                        help="device micro-batch size (default from "
                             "PredictConfig: 8)")
    parser.add_argument("--max_wait_ms", type=float, default=25.0,
                        help="how long the first request of a batch waits "
                             "for the batch to fill (latency/throughput "
                             "knob)")
    parser.add_argument("--queue_limit", type=int, default=256,
                        help="pending-request bound; beyond it requests "
                             "get 503 backpressure")
    parser.add_argument("--float32", action="store_true", default=False,
                        help="run the conv stack in float32 (TF32 off) "
                             "instead of bfloat16")
    parser.add_argument("--int8", action="store_true", default=False,
                        help="int8 inference (post-training quantization "
                             "calibrated on the warm-up batch, or the first "
                             "request's with --no_warmup); approximate, "
                             "ResNet models only")
    parser.add_argument("--no_warmup", action="store_true", default=False,
                        help="skip running the canonical 1024x1024 launch "
                             "shapes at startup")
    parser.add_argument("--timeout_s", type=float, default=180.0,
                        help="per-request result timeout")
    parser.add_argument("--fixed_height", type=int, default=1024,
                        help="pin every launch of a request at most this "
                             "tall to this pad height (0 to disable): the "
                             "dark-band trim gives each request its own "
                             "height, and a height bucket the warmup did "
                             "not run pays a one-off set-up under traffic; "
                             "padding to one height is exact (row masks)")
    return parser


class _ServerState:
    """Everything handlers need, hung off the server instance."""

    def __init__(self, predictor, preprocessor, model_name: str,
                 timeout_s: float, dpi: int):
        self.predictor = predictor
        self.preprocessor = preprocessor
        self.model_name = model_name
        self.timeout_s = timeout_s
        self.dpi = dpi
        self.started = time.time()


class BarkHandler(BaseHTTPRequestHandler):
    # per-request lines on stderr are noise at serving rates
    def log_message(self, fmt, *args):  # pragma: no cover
        pass

    @property
    def state(self) -> _ServerState:
        return self.server.state  # type: ignore[attr-defined]

    # ------------------------------------------------------------ helpers

    def _send(self, code: int, body: bytes, ctype: str,
              extra: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: dict,
                   extra: dict | None = None) -> None:
        self._send(code, json.dumps(payload).encode(), "application/json",
                   extra)

    # ------------------------------------------------------------- routes

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        path = urlparse(self.path).path
        if path == "/healthz":
            self._send_json(200, {
                "ok": True, "model": self.state.model_name,
                "backend": self.state.predictor.calc.device.type,
                "n_devices": torch.cuda.device_count(),
                "uptime_s": round(time.time() - self.state.started, 1),
            })
        elif path == "/v1/stats":
            self._send_json(200, self.state.predictor.snapshot_stats())
        else:
            self._send_json(404, {"error": f"no route {path!r}"})

    def do_POST(self) -> None:  # noqa: N802 (stdlib API)
        parsed = urlparse(self.path)
        if parsed.path != "/v1/predict":
            self._send_json(404, {"error": f"no route {parsed.path!r}"})
            return
        q = parse_qs(parsed.query)
        fmt = q.get("format", ["json"])[0]
        if fmt not in ("json", "mask", "combined"):
            self._send_json(400, {"error": f"unknown format {fmt!r}"})
            return
        exclude_nodes = q.get("exclude_nodes", ["0"])[0] in ("1", "true")
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0 or length > MAX_BODY_BYTES:
            self._send_json(400, {"error": "body must be image bytes "
                                           f"(<= {MAX_BODY_BYTES} B)"})
            return
        body = self.rfile.read(length)

        try:
            img = _decode_image(body)
        except Exception as e:  # PIL raises many kinds on bad bytes
            self._send_json(400, {"error": f"undecodable image: {e}"})
            return
        try:
            processed = self.state.preprocessor.preprocess_one(img)
        except (ValueError, RuntimeError) as e:
            self._send_json(400, {"error": f"preprocess failed: {e}"})
            return
        try:
            fut = self.state.predictor.submit(processed, exclude_nodes)
        except queue.Full:
            self._send_json(503, {"error": "server saturated, retry"},
                            extra={"Retry-After": "1"})
            return
        except RuntimeError as e:  # predictor closed (shutdown race)
            self._send_json(503, {"error": str(e)},
                            extra={"Retry-After": "1"})
            return
        except ValueError as e:
            self._send_json(400, {"error": str(e)})
            return
        try:
            res = fut.result(timeout=self.state.timeout_s)
        except Exception as e:  # the engine's error, or the timeout
            self._send_json(500, {"error": f"prediction failed: {e}"})
            return

        if fmt == "json":
            self._send_json(200, {
                "width": int(res.class_map.shape[1]),
                "height": int(res.class_map.shape[0]),
                "source_height": int(img.shape[0]),
                "source_width": int(img.shape[1]),
                "bark_percent": round(res.bark_percent, 5),
                "bark_area_mm2": round(res.bark_area_mm2, 5),
                "node_percent": round(res.node_percent, 5),
                "node_area_mm2": round(res.node_area_mm2, 5),
                "class_pixels": [int(c) for c in res.counts],
                "queue_ms": round(res.queue_ms, 2),
                "compute_ms": round(res.compute_ms, 2),
                "batch_images": res.batch_images,
            })
        elif fmt == "mask":
            self._send(200, _dual_png_bytes(res.class_map), "image/png")
        else:  # combined figure
            try:
                dpi = int(q.get("dpi", [str(self.state.dpi)])[0])
            except ValueError:
                dpi = self.state.dpi
            self._send(200, _combined_png_bytes(res, dpi), "image/png")


def _decode_image(body: bytes) -> np.ndarray:
    """Request bytes -> uint8 RGB array (PIL: PNG/BMP/JPEG/TIFF/...)."""
    from PIL import Image
    with Image.open(io.BytesIO(body)) as im:
        return np.asarray(im.convert("RGB"))


def _dual_png_bytes(class_map: np.ndarray) -> bytes:
    """In-memory dual PNG, bark=127 node=255 (models.py:349-356)."""
    from PIL import Image
    dual = np.zeros(class_map.shape, np.uint8)
    dual[class_map == 1] = 127
    dual[class_map == 2] = 255
    buf = io.BytesIO()
    Image.fromarray(dual, mode="L").save(buf, format="PNG")
    return buf.getvalue()


def _combined_png_bytes(res, dpi: int) -> bytes:
    """The combined Input / Generated figure as PNG bytes (the compositor
    writes files; served through a temporary path)."""
    from ..pipeline.compositor import render_combined_fast
    percents = [res.bark_percent, res.node_percent]
    fd, path = tempfile.mkstemp(suffix=".png")
    os.close(fd)
    try:
        render_combined_fast(res.image, res.class_map, path, percents, dpi,
                             legend_values=[v for v in range(3)
                                            if res.counts[v] > 0])
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def make_engine(args: argparse.Namespace, mesh=None):
    """The server's engine for ``args``, under ``mesh`` (this rank's
    place in a ``(data, model)`` grid; None: one process)."""
    from ..config import PredictConfig
    from ..pipeline.predict import NeuralBarkCalculator

    config = PredictConfig(model_path=args.model_path)
    if args.batch_size is not None:
        config.batch_size = args.batch_size
    if args.float32:
        config.use_bfloat16 = False
    if args.int8:
        config.quantize_int8 = True
    if args.fixed_height:
        config.fixed_pad_height = args.fixed_height
    return NeuralBarkCalculator(args.model_path, config=config,
                                model_name=args.model, device=args.device,
                                mesh=mesh)


def make_server(args: argparse.Namespace, mesh=None) -> ThreadingHTTPServer:
    """Build the engine, the batcher and the HTTP server (not serving
    yet); apart from main() so tests can run it on an ephemeral port.
    ``mesh``: as ``make_engine``'s; grid rank 0 serves."""
    from ..pipeline.preprocess import Preprocessor
    from ..pipeline.serving import BatchingPredictor

    calc = make_engine(args, mesh)
    config = calc.config
    predictor = BatchingPredictor(calc, batch_size=config.batch_size,
                                  max_wait_ms=args.max_wait_ms,
                                  queue_limit=args.queue_limit)
    server = ThreadingHTTPServer((args.host, args.port), BarkHandler)
    server.state = _ServerState(  # type: ignore[attr-defined]
        predictor, Preprocessor(device=args.device), args.model,
        args.timeout_s, config.figure_dpi)
    return server


def main(args: argparse.Namespace) -> None:
    server = make_server(args)
    state: _ServerState = server.state  # type: ignore[attr-defined]
    if not args.no_warmup:
        print("warming up (running the canonical launch shapes)...",
              flush=True)
        state.predictor.warmup()
    host, port = server.server_address[:2]
    print(f"serving {args.model} from {args.model_path} on "
          f"http://{host}:{port} ({args.device}, batch "
          f"{state.predictor.batch_size}, max wait "
          f"{state.predictor.max_wait_ms:g} ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        state.predictor.close()


def serve_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    """Run serve_forever on a daemon thread (tests, embedding)."""
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="serve-http")
    t.start()
    return t


def entrypoint() -> None:
    """console_scripts entry (pyproject: bark-serve-torch)."""
    main(build_parser().parse_args())


if __name__ == "__main__":
    entrypoint()
