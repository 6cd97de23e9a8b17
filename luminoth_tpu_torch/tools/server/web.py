"""Web demo server of the port: upload an image, get JSON detections and a
preview.

Counterpart of the JAX package's ``tools/server/web.py``, on the stdlib's
threading HTTP server: ``GET /`` serves the page, ``POST
/api/<model>/predict/`` takes the image (multipart field ``image``, or the
raw body) and answers ``{"objects": [...]}``, the ``Detector.predict``
format. The model loads on a background thread; until it is ready a
request gets HTTP 503. Concurrent requests are coalesced into batched
forwards by a :class:`~luminoth_tpu_torch.utils.serving.MicroBatcher`.

    python -m luminoth_tpu_torch server web -c config.yml --port 5000

The weights are the newest training checkpoint under the config's
``train.job_dir``, or a checkpoint of the zoo (``--checkpoint``; without
``--config`` either, ``accurate``), served with its class labels.
"""

import io
import json
import logging
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import click
import numpy as np
import torch

logger = logging.getLogger(__name__)

MIN_PROB_FOR_FRONTEND = 0.01


def _template_path():
    return os.path.join(os.path.dirname(__file__), "templates", "index.html")


def _parse_multipart(body, content_type):
    """Minimal multipart/form-data parser. Returns (image_bytes, params)."""
    match = re.search(r'boundary="?([^";,]+)"?', content_type)
    if not match:
        return None, {}
    boundary = b"--" + match.group(1).encode()
    image_bytes = None
    params = {}
    for part in body.split(boundary):
        # Trim exactly the framing CRLFs (one each side): binary content
        # may itself start or end with 0x0D/0x0A.
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part == b"--":
            continue
        header_blob, _, content = part.partition(b"\r\n\r\n")
        headers = header_blob.decode("utf-8", "replace")
        name_match = re.search(r'name="([^"]+)"', headers)
        if not name_match:
            continue
        name = name_match.group(1)
        if name == "image":
            image_bytes = content
        else:
            params[name] = content.decode("utf-8", "replace").strip()
    return image_bytes, params


class ServerState:
    """What one server's handlers share: the network once it is loaded,
    the loading error if it failed, and the model's name for the page."""

    def __init__(self, model_name="model"):
        self.model_name = model_name
        self.network = None
        self.error = None
        self.ready = threading.Event()


def start_network(config, class_labels=None, batch_size=8,
                  batch_wait_ms=2.0, device=None):
    """The predictor of ``config`` on ``device``; with ``batch_size`` > 1
    behind a :class:`MicroBatcher` that coalesces concurrent requests."""
    from luminoth_tpu_torch.utils.predicting import PredictorNetwork
    from luminoth_tpu_torch.utils.serving import MicroBatcher

    network = PredictorNetwork(config, class_labels=class_labels,
                               device=device)
    if batch_size > 1:
        network = MicroBatcher(network, max_batch=batch_size,
                               max_wait_ms=batch_wait_ms)
    logger.info("Model loaded and ready to serve.")
    return network


class Handler(BaseHTTPRequestHandler):
    """Serves one request; the state is the server's ``state``."""

    def _send_json(self, payload, status=200):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            try:
                with open(_template_path(), "rb") as f:
                    body = f.read()
            except OSError:
                body = b"<html><body>luminoth-tpu server</body></html>"
            body = body.replace(
                b"{{ model_name }}", self.server.state.model_name.encode()
            )
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_json({"error": "not found"}, status=404)

    def do_POST(self):
        if not self.path.startswith("/api/") or "/predict" not in self.path:
            self._send_json({"error": "not found"}, status=404)
            return

        content_type = self.headers.get("Content-Type", "")
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        params = {}
        if content_type.startswith("multipart/form-data"):
            image_bytes, params = _parse_multipart(body, content_type)
        else:
            image_bytes = body

        if not image_bytes:
            self._send_json({"error": "missing image"}, status=400)
            return

        try:
            from PIL import Image

            image = np.asarray(
                Image.open(io.BytesIO(image_bytes)).convert("RGB")
            )
        except Exception:
            self._send_json({"error": "incorrect image format"}, status=400)
            return

        state = self.server.state
        if not state.ready.is_set():
            self._send_json({"error": "model is loading"}, status=503)
            return
        if state.network is None:
            self._send_json(
                {"error": f"model failed to load: {state.error}"}, status=500
            )
            return

        # Malformed form fields come back as HTTP 400, not a dropped
        # connection.
        try:
            min_prob = float(params.get("min_prob", 0) or 0)
            total = int(params["total"]) if params.get("total") else None
        except (TypeError, ValueError):
            self._send_json(
                {"error": "min_prob/total must be numeric"}, status=400
            )
            return

        try:
            objects = state.network.predict_image(image)
        except Exception as exc:  # surface predict errors as HTTP 500
            logger.exception("predict failed")
            self._send_json(
                {"error": f"prediction failed: {exc}"}, status=500
            )
            return
        # No server-side floor by default: the page's slider filters on
        # the client. API callers may pass min_prob to filter here.
        if min_prob:
            objects = [o for o in objects if o["prob"] >= min_prob]
        if total is not None:
            objects = objects[:total]
        self._send_json({"objects": objects})

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)


def run_server(config, class_labels=None, host="127.0.0.1", port=5000,
               block=True, batch_size=8, batch_wait_ms=2.0, device=None):
    """Start the demo server; returns the server object (its ``state``
    holds the network once loaded). Stop it with :func:`stop_server`."""
    from luminoth_tpu_torch.utils.predicting import resolve_device

    # Set up the device (and its CUDA context) on the main thread before
    # the loader thread touches it.
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()

    state = ServerState(config.model.type)

    def load():
        try:
            state.network = start_network(
                config, class_labels, batch_size=batch_size,
                batch_wait_ms=batch_wait_ms, device=device)
        except Exception as e:  # answered as HTTP 500
            logger.exception("model failed to load")
            state.error = e
        finally:
            state.ready.set()

    threading.Thread(target=load, daemon=True).start()
    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.state = state
    logger.info("Serving on http://%s:%d", host, httpd.server_address[1])
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def stop_server(httpd):
    """Stop a server of :func:`run_server` started with ``block=False``,
    close its socket and its batcher."""
    httpd.shutdown()
    httpd.server_close()
    close = getattr(httpd.state.network, "close", None)
    if close is not None:
        close()


@click.command(help="Start basic web application.")
@click.option(
    "config_files", "--config", "-c", multiple=True, help="Config to use.")
@click.option("--checkpoint", help="Checkpoint to use.")
@click.option(
    "override_params", "--override", "-o", multiple=True,
    help="Override model config params.")
@click.option("--host", default="127.0.0.1", help="Hostname to listen on.")
@click.option("--port", default=5000, type=int, help="Port to listen to.")
@click.option(
    "--batch-size", default=8, type=int,
    help="Coalesce up to this many concurrent requests per device "
         "forward (1 disables batching).")
@click.option(
    "--batch-wait-ms", default=2.0, type=float,
    help="How long to wait for more requests to join a batch.")
@click.option(
    "--profile", default="accurate",
    type=click.Choice(["accurate", "fast"]),
    help="Serving profile: 'fast' = uint8 transfer, the 6000/1000 "
         "proposal budget and int8 with calibrated scales (see "
         "utils/serving.py:apply_serving_profile).")
@click.option(
    "--device", default=None,
    help="Torch device (default: the current CUDA device).")
@click.option("--debug", is_flag=True, help="Set debug level logging.")
def web(config_files, checkpoint, override_params, host, port, batch_size,
        batch_wait_ms, profile, device, debug):
    logging.basicConfig(level=logging.DEBUG if debug else logging.INFO)
    from luminoth_tpu_torch.utils.config import (
        get_config,
        override_config_params,
        proposals_config,
    )
    from luminoth_tpu_torch.utils.serving import apply_serving_profile

    if config_files:
        config = get_config(list(config_files))
        class_labels = None
    else:
        from luminoth_tpu_torch.tools.checkpoint import (
            get_checkpoint_class_labels,
            get_checkpoint_config,
        )

        name = checkpoint or "accurate"
        if not checkpoint:
            click.echo("Neither checkpoint nor config specified, assuming "
                       "`accurate`.")
        config = get_checkpoint_config(name)
        class_labels = get_checkpoint_class_labels(name)
    if override_params:
        config = override_config_params(config, override_params)
    config = apply_serving_profile(config, profile)
    # A low floor, so the page's slider can filter on the client.
    proposals_config(config).min_prob_threshold = MIN_PROB_FOR_FRONTEND

    run_server(config, class_labels=class_labels, host=host, port=port,
               batch_size=batch_size, batch_wait_ms=batch_wait_ms,
               device=device)
