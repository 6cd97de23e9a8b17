"""The port's predict/serve surface against the JAX package (CPU).

The small configuration and the JAX checkpoint of ``tests/test_torch_eval.py``
(Faster R-CNN ResNet-50 v1, 3 classes, a 96 x 128 canvas, a full JAX train
state written by the JAX ``CheckpointManager`` under ``job_dir``).

Checked here: ``PredictorNetwork(config)`` with no variables loads the
newest checkpoint (msgpack or ``.pt``) and predicts what the JAX predictor
predicts from the same ``job_dir``; the ``predict`` command writes the JSON
lines of the JAX command; ``MicroBatcher`` and ``apply_serving_profile``
pass the cases of ``tests/test_serving.py``; the web server answers a POST
with ``Detector.predict``'s objects, and 503 before the model is loaded.
"""

import functools
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from luminoth_tpu import predict as jax_predict
from luminoth_tpu.utils.config import get_config as jax_get_config
from luminoth_tpu.utils.predicting import PredictorNetwork as JaxPredictor
from luminoth_tpu_torch import predict as port_predict
from luminoth_tpu_torch.cli import cli
from luminoth_tpu_torch.tasks import Detector
from luminoth_tpu_torch.tools.server import web
from luminoth_tpu_torch.utils import predicting
from luminoth_tpu_torch.utils.checkpoint_io import CheckpointManager
from luminoth_tpu_torch.utils.config import get_config
from luminoth_tpu_torch.utils.serving import (
    MicroBatcher,
    apply_serving_profile,
)
from test_torch_eval import STEP, small  # noqa: F401 (a fixture)
from test_torch_isolation import few_threads, jax_cache_isolation  # noqa: F401

BOX_ATOL = 1e-2  # px
PROB_ATOL = 1e-4 + 1e-5  # the outputs round probabilities to 4 decimals
TIMEOUT = 120


def image_files(directory, count=3):
    """``count`` noise JPEGs of different sizes; returns their paths."""
    rng = np.random.default_rng(3)
    paths = []
    for i in range(count):
        pixels = rng.integers(0, 256, (70 + 10 * i, 100 - 5 * i, 3),
                              dtype=np.uint8)
        path = directory / f"img{i}.jpg"
        Image.fromarray(pixels).save(path, quality=90)
        paths.append(str(path))
    return paths


def assert_objects_close(got, want):
    """Per image lists of ``{bbox, label, prob}``: same labels in the same
    order, boxes and probabilities within the tolerances."""
    assert len(got) == len(want) > 0
    assert [o["label"] for o in got] == [o["label"] for o in want]
    np.testing.assert_allclose([o["bbox"] for o in got],
                               [o["bbox"] for o in want], rtol=0,
                               atol=BOX_ATOL)
    np.testing.assert_allclose([o["prob"] for o in got],
                               [o["prob"] for o in want], rtol=0,
                               atol=PROB_ATOL)


# ------------------------------------------------------------ predicting


class TestPredictor:
    def test_loads_the_newest_checkpoint_like_jax(self, small):
        images = [np.asarray(Image.open(p)) for p in
                  image_files(small["root"])]
        want = JaxPredictor(jax_get_config([small["path"]]), mesh=None)
        got = predicting.PredictorNetwork(get_config(small["path"]),
                                          device="cpu")
        for g, w in zip(got.predict_batch(images, pad_to=4),
                        want.predict_batch(images, pad_to=4)):
            assert_objects_close(g, w)

    def test_pt_and_msgpack_predict_alike(self, small, tmp_path):
        """A ``.pt`` checkpoint of the msgpack's weights, in the
        ``job_dir/ckpt`` layout, predicts exactly the same."""
        config = get_config(small["path"])
        from_msgpack = predicting.PredictorNetwork(config, device="cpu")
        CheckpointManager(str(tmp_path / "ckpt")).save(
            {"step": STEP, "model": from_msgpack._model.state_dict()}, STEP)
        config.train.job_dir = str(tmp_path)
        from_pt = predicting.PredictorNetwork(config, device="cpu")
        image = np.asarray(Image.open(image_files(tmp_path, 1)[0]))
        assert from_pt.predict_image(image) == from_msgpack.predict_image(
            image)

    def test_no_checkpoint_raises(self, small, tmp_path):
        config = get_config(small["path"])
        config.train.job_dir = str(tmp_path)
        with pytest.raises(FileNotFoundError):
            predicting.PredictorNetwork(config, device="cpu")


@pytest.mark.parametrize("batch_size", [1, 2])
def test_predict_command_equals_jax(small, tmp_path, monkeypatch,
                                    batch_size):
    """The JSON lines of the port's ``predict`` against the JAX command's
    (its predictor on one device)."""
    monkeypatch.setattr(jax_predict, "PredictorNetwork",
                        functools.partial(JaxPredictor, mesh=None))
    paths = image_files(tmp_path)
    args = [*paths, "-c", small["path"], "--min-prob", "0.05",
            "--batch-size", str(batch_size)]
    outputs = {}
    for name, command, extra in (("jax", jax_predict.predict, []),
                                 ("port", port_predict.predict,
                                  ["--device", "cpu"])):
        out = tmp_path / f"{name}.jsonl"
        result = CliRunner().invoke(command, args + extra + ["-f", str(out)])
        assert result.exit_code == 0, result.output
        outputs[name] = [json.loads(line) for line in
                         out.read_text().splitlines()]
    assert [r["file"] for r in outputs["port"]] == paths
    assert [r["file"] for r in outputs["jax"]] == paths
    for got, want in zip(outputs["port"], outputs["jax"]):
        assert_objects_close(got["objects"], want["objects"])
        assert min(o["prob"] for o in got["objects"]) >= 0.05


def test_predict_command_saves_media(small, tmp_path):
    paths = image_files(tmp_path, 1)
    media, out = tmp_path / "media", tmp_path / "out.jsonl"
    result = CliRunner().invoke(port_predict.predict, [
        *paths, "-c", small["path"], "--device", "cpu", "-d", str(media),
        "-f", str(out)])
    assert result.exit_code == 0, result.output
    assert json.loads(out.read_text())["file"] == paths[0]
    assert Image.open(media / "pred_img0.jpg").size == (100, 70)


@pytest.mark.parametrize("args, error", [
    (["--checkpoint", "accurate"], ValueError),
    ([], ValueError),  # no config: the zoo's default, ``accurate``
])
def test_predict_command_without_a_config_needs_the_zoo(tmp_path, args,
                                                        error, monkeypatch):
    """Without a config the command resolves the checkpoint in the zoo
    (``tests/test_torch_zoo.py`` serves one); an empty zoo raises the JAX
    package's error."""
    monkeypatch.setenv("LUMI_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("LUMI_REMOTE_INDEX_URL", raising=False)
    paths = image_files(tmp_path, 1)
    result = CliRunner().invoke(port_predict.predict, [*paths, *args])
    assert isinstance(result.exception, error)
    assert "'accurate' not found in index" in str(result.exception)


@pytest.mark.parametrize("command", [
    ["predict", "{image}", "-c", "{config}"],
    ["server", "web", "-c", "{config}", "--port", "0"],
    ["eval", "-c", "{config}", "--no-watch"],
])
def test_commands_need_a_cuda_device(small, tmp_path, monkeypatch, command):
    """Without ``--device`` every command takes the CUDA device, and
    raises when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    image = image_files(tmp_path, 1)[0]
    args = [a.format(image=image, config=small["path"]) for a in command]
    result = CliRunner().invoke(cli, args)
    assert isinstance(result.exception, RuntimeError), result.output
    assert "CUDA" in str(result.exception)


def test_cli_lists_the_ported_commands():
    result = CliRunner().invoke(cli, ["--help"])
    assert result.exit_code == 0
    assert cli.list_commands(None) == ["checkpoint", "dataset", "eval",
                                       "predict", "server", "train"]
    for name in cli.list_commands(None):
        assert name in result.output
    assert CliRunner().invoke(cli, ["cloud"]).exit_code != 0
    result = CliRunner().invoke(cli, ["dataset", "--help"])
    assert result.exit_code == 0
    for name in ("transform", "merge"):
        assert name in result.output


# ---------------------------------------------------------------- serving


class StubNetwork:
    """Records batch compositions; returns per-image identifiers."""

    def __init__(self, delay_s=0.0, fail=False):
        self.calls = []
        self.delay_s = delay_s
        self.fail = fail

    def predict_batch(self, images, pad_to=None):
        self.calls.append((len(images), pad_to))
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail:
            raise RuntimeError("boom")
        return [[{"label": int(img)}] for img in images]


def submit_all(batcher, count):
    """``count`` concurrent ``predict_image`` calls; returns
    ``(results, errors)`` by request."""
    results, errors = {}, {}

    def submit(i):
        try:
            results[i] = batcher.predict_image(i)
        except RuntimeError as e:
            errors[i] = str(e)

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    return results, errors


class TestMicroBatcher:
    def test_single_request_roundtrip(self):
        net = StubNetwork()
        batcher = MicroBatcher(net, max_batch=8, max_wait_ms=1.0)
        assert batcher.predict_image(7) == [{"label": 7}]
        assert net.calls == [(1, 1)]
        batcher.close()

    def test_concurrent_requests_batch_together(self):
        net = StubNetwork()
        # A generous window so all threads join one batch.
        batcher = MicroBatcher(net, max_batch=8, max_wait_ms=150.0)
        results, _ = submit_all(batcher, 4)
        assert results == {i: [{"label": i}] for i in range(4)}
        assert net.calls == [(4, 4)]  # one forward, a power-of-two bucket
        batcher.close()

    def test_burst_larger_than_max_batch_splits(self):
        net = StubNetwork()
        batcher = MicroBatcher(net, max_batch=2, max_wait_ms=100.0)
        results, _ = submit_all(batcher, 5)
        assert results == {i: [{"label": i}] for i in range(5)}
        assert sum(n for n, _ in net.calls) == 5
        assert all(n <= 2 and pad <= 2 for n, pad in net.calls)
        batcher.close()

    def test_padding_buckets_are_powers_of_two(self):
        batcher = MicroBatcher(StubNetwork(), max_batch=8)
        assert [batcher._bucket(n) for n in (1, 2, 3, 4, 5, 8, 9)] == [
            1, 2, 4, 4, 8, 8, 8
        ]
        batcher.close()

    def test_errors_propagate_to_every_waiter(self):
        batcher = MicroBatcher(StubNetwork(fail=True), max_batch=4,
                               max_wait_ms=50.0)
        _, errors = submit_all(batcher, 3)
        assert sorted(errors.values()) == ["boom"] * 3
        batcher.close()

    def test_closed_batcher_rejects(self):
        batcher = MicroBatcher(StubNetwork())
        batcher.close()
        with pytest.raises(RuntimeError):
            batcher.predict_image(1)

    def test_max_batch_validation(self):
        with pytest.raises(ValueError):
            MicroBatcher(StubNetwork(), max_batch=0)

    def test_start_network_wraps_in_batcher(self, monkeypatch):
        class FakePredictor:
            def __init__(self, config, class_labels=None, device=None):
                self.device = device

            def predict_batch(self, images, pad_to=None):
                return [[{"label": "ok"}] for _ in images]

        monkeypatch.setattr(predicting, "PredictorNetwork", FakePredictor)
        network = web.start_network(None, batch_size=4, device="cpu")
        assert isinstance(network, MicroBatcher)
        assert network.predict_image("img") == [{"label": "ok"}]
        network.close()
        network = web.start_network(None, batch_size=1, device="cpu")
        assert isinstance(network, FakePredictor) and network.device == "cpu"


class TestServingProfile:
    def test_accurate_is_a_no_op_and_fast_sets_the_knobs(self, small):
        config = get_config(small["path"])
        post = config.model.rpn.proposals.post_nms_top_n
        config = apply_serving_profile(config, "accurate")
        assert config.model.rpn.proposals.post_nms_top_n == post
        assert config.dataset.transfer_dtype == "float32"

        config = apply_serving_profile(config, "fast")
        assert config.dataset.transfer_dtype == "uint8"
        assert config.model.rpn.proposals.post_nms_top_n == 1000
        assert config.model.rpn.proposals.pre_nms_top_n == 6000
        assert config.model.base_network.int8_tail is True
        assert config.model.base_network.int8_static is True
        with pytest.raises(ValueError):
            apply_serving_profile(config, "warp9")

    def test_fast_reaches_the_model_build(self, small):
        """The fast profile's flags reach the model build: the int8 tail
        with static scales, calibrated at load, serves."""
        from luminoth_tpu_torch.models.base.quantized_tail import (
            Int8ResNetTail,
            needs_calibration,
        )

        config = apply_serving_profile(get_config(small["path"]), "fast")
        network = predicting.PredictorNetwork(config, device="cpu")
        tail = network._model.base_network_tail.resnet_v1_50
        assert isinstance(tail, Int8ResNetTail)
        assert not needs_calibration(network._model)
        image = np.asarray(Image.open(image_files(small["root"], 1)[0]))
        assert isinstance(network.predict_image(image), list)


# ------------------------------------------------------------- web server


def multipart(image_bytes, fields=None):
    """``(body, content type)`` of a form with ``image`` and ``fields``."""
    boundary = "xxBOUNDARYxx"
    body = (f"--{boundary}\r\n".encode()
            + b'Content-Disposition: form-data; name="image"; '
              b'filename="a.jpg"\r\nContent-Type: image/jpeg\r\n\r\n'
            + image_bytes + b"\r\n")
    for name, value in (fields or {}).items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"\r\n\r\n{value}\r\n').encode()
    body += f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def post(port, body, content_type=None):
    """``(status, payload)`` of a POST to the predict endpoint."""
    headers = {"Content-Type": content_type} if content_type else {}
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/fasterrcnn/predict/", data=body,
        method="POST", headers=headers)
    try:
        with urllib.request.urlopen(request, timeout=TIMEOUT) as response:
            return response.status, json.load(response)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


@pytest.fixture
def bare_server():
    """A server whose state the test sets: no model loads."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), web.Handler)
    httpd.state = web.ServerState("fasterrcnn")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=TIMEOUT)


def jpeg_bytes(size=(40, 30)):
    buf = io.BytesIO()
    Image.new("RGB", size, (90, 20, 200)).save(buf, "JPEG")
    return buf.getvalue()


class TestWebServer:
    def test_post_answers_what_detector_predicts(self, small):
        config = get_config(small["path"])
        httpd = web.run_server(config, port=0, block=False, batch_size=8,
                               device="cpu")
        try:
            assert httpd.state.ready.wait(TIMEOUT)
            assert isinstance(httpd.state.network, MicroBatcher)
            port = httpd.server_address[1]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                        timeout=TIMEOUT) as response:
                assert b"fasterrcnn" in response.read()
            image_bytes = open(image_files(small["root"], 1)[0], "rb").read()
            status, payload = post(port, *multipart(image_bytes))
        finally:
            web.stop_server(httpd)
        image = np.asarray(Image.open(io.BytesIO(image_bytes))
                           .convert("RGB"))
        want = Detector(config=small["path"], device="cpu",
                        prob=0.0).predict(image)
        assert status == 200
        assert payload["objects"] == want and len(want) > 0

    def test_503_until_the_model_is_loaded(self, bare_server):
        port = bare_server.server_address[1]
        assert post(port, *multipart(jpeg_bytes()))[0] == 503
        state = bare_server.state
        state.error = RuntimeError("no weights")
        state.ready.set()
        status, payload = post(port, *multipart(jpeg_bytes()))
        assert status == 500 and "no weights" in payload["error"]

    def test_filters_and_errors(self, bare_server):
        class FakeNetwork:
            def predict_image(self, image):
                return [
                    {"bbox": [1, 2, 3, 4], "label": "cat", "prob": 0.9},
                    {"bbox": [1, 2, 3, 4], "label": "dog", "prob": 0.2},
                ]

        bare_server.state.network = FakeNetwork()
        bare_server.state.ready.set()
        port = bare_server.server_address[1]
        assert len(post(port, jpeg_bytes())[1]["objects"]) == 2  # raw body
        payload = post(port, *multipart(jpeg_bytes(), {"min_prob": 0.5}))[1]
        assert [o["label"] for o in payload["objects"]] == ["cat"]
        payload = post(port, *multipart(jpeg_bytes(), {"total": 1}))[1]
        assert len(payload["objects"]) == 1
        assert post(port, *multipart(jpeg_bytes(),
                                     {"min_prob": "x"}))[0] == 400
        assert post(port, *multipart(b"not an image"))[0] == 400
        assert post(port, b"")[0] == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=TIMEOUT)
        assert e.value.code == 404

    def test_multipart_keeps_crlf_edges_of_a_binary_payload(self):
        payload = b"\r\nBINARY\x0d\x0a"
        body, content_type = multipart(payload, {"min_prob": "0.25"})
        image, params = web._parse_multipart(body, content_type)
        assert image == payload
        assert params == {"min_prob": "0.25"}

    def test_web_command_without_a_config_needs_the_zoo(self, tmp_path,
                                                        monkeypatch):
        monkeypatch.setenv("LUMI_HOME", str(tmp_path / "home"))
        monkeypatch.delenv("LUMI_REMOTE_INDEX_URL", raising=False)
        result = CliRunner().invoke(web.web, ["--port", "0"])
        assert isinstance(result.exception, ValueError)
        assert "'accurate' not found in index" in str(result.exception)
