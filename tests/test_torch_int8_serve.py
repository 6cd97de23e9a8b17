"""The port's SSD ``fast`` profile served end to end against the JAX
package (CPU): calibration at load (synthetic canvas and
``int8_calibration_images``), ``PredictorNetwork``, a one-image request,
the ``predict`` command and the web server under ``--profile fast``.

The weights are random from a seed, with SSD's float stage (conv1/conv2)
made of single-tap power-of-two kernels, so that it is exact in any
summation order (``tests/test_torch_int8.py``'s docstring says why): the
calibrated maxima then equal the JAX predictor's bitwise and each
detection pairs with one of JAX's of the same label, box (within
``BOX_ATOL`` px) and probability (within the 4-place rounding).
"""

import copy
import functools
import io
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

from luminoth_tpu import predict as jax_predict
from luminoth_tpu.utils.predicting import PredictorNetwork as JaxPredictor
from luminoth_tpu_torch import predict as port_predict
from luminoth_tpu_torch.tools.server import web
from luminoth_tpu_torch.utils import predicting
from luminoth_tpu_torch.utils.config import get_config
from luminoth_tpu_torch.utils.serving import apply_serving_profile
from luminoth_tpu_torch.utils.weights import flatten_variables, init_variables
from test_torch_int8 import (
    assert_paired,
    exact_ssd_float_stage,
    int8_stats,
    port_stats,
)
from test_torch_isolation import few_threads, jax_cache_isolation  # noqa: F401
from test_torch_serve import image_files, multipart
from test_torch_ssd import jax_variables as ssd_jax_variables
from test_torch_ssd import predictor_images, small_config as ssd_config


def exact_ssd_variables(config):
    flat = flatten_variables(init_variables(config, seed=0))
    return ssd_jax_variables(
        config, exact_ssd_float_stage(flat, np.random.RandomState(7)))


@pytest.fixture(scope="module")
def ssd_fast():
    """SSD (3 classes) under the ``fast`` profile with an exact float
    stage: the JAX predictor and the port's, each calibrated at load."""
    config = apply_serving_profile(ssd_config(), "fast")
    variables = exact_ssd_variables(ssd_config())
    return (config, variables,
            JaxPredictor(config, variables=variables, mesh=None),
            predicting.PredictorNetwork(config, variables=variables,
                                        device="cpu"))


@pytest.fixture(scope="module")
def ssd_job(tmp_path_factory, ssd_fast):
    """An SSD config file and a JAX checkpoint of ``ssd_fast``'s weights
    under ``job_dir/small/ckpt``, for the commands."""
    import optax
    import yaml
    from luminoth_tpu.train import TrainState
    from luminoth_tpu.utils import checkpoint_io as jax_checkpoint_io

    root = tmp_path_factory.mktemp("ssd_fast")
    path = root / "ssd.yml"
    path.write_text(yaml.safe_dump({
        "model": {"type": "ssd", "network": {"num_classes": 3}},
        "train": {"job_dir": str(root / "jobs"), "run_name": "small"}}))
    params = ssd_fast[1]["params"]
    jax_checkpoint_io.CheckpointManager(
        str(root / "jobs" / "small" / "ckpt")).save(
        TrainState(step=jnp.asarray(1, jnp.int32), params=params,
                   opt_state=optax.adam(1e-3).init(params), batch_stats={}),
        1)
    return {"path": str(path), "root": root}



class TestCalibration:
    def test_ssd_scales_equal_jax(self, ssd_fast):
        _, _, want, got = ssd_fast
        assert got.int8_calibration_s is not None
        assert port_stats(got._model) == int8_stats(want._variables)

    def test_calibration_images_equal_jax(self, ssd_fast, tmp_path):
        """``int8_calibration_images``: each file through the real
        preprocessing, one at a time; the running maxima equal JAX's."""
        config, variables, _, synthetic = ssd_fast
        config = copy.deepcopy(config)
        config.model.base_network.int8_calibration_images = image_files(
            tmp_path, 2)
        want = JaxPredictor(config, variables=variables, mesh=None)
        got = predicting.PredictorNetwork(config, variables=variables,
                                          device="cpu")
        assert port_stats(got._model) == int8_stats(want._variables)
        assert port_stats(synthetic._model) != port_stats(got._model)



class TestServing:
    def test_ssd_detections_equal_jax(self, ssd_fast):
        _, _, want, got = ssd_fast
        images = predictor_images()
        for g, w in zip(got.predict_batch(images),
                        want.predict_batch(images)):
            assert_paired(g, w)

    def test_one_image_ssd_request(self, ssd_fast):
        """One image: conv11_2's 1x1 map has one row, padded to
        ``MIN_ROWS`` for the product."""
        _, _, want, got = ssd_fast
        image = predictor_images()[0]
        assert_paired(got.predict_image(image), want.predict_image(image))



def test_predict_command_fast_equals_jax(ssd_job, tmp_path, monkeypatch):
    """``predict --profile fast`` from a JAX checkpoint (SSD, the exact
    float stage): the port's JSON lines pair with the JAX command's."""
    monkeypatch.setattr(jax_predict, "PredictorNetwork",
                        functools.partial(JaxPredictor, mesh=None))
    paths = image_files(tmp_path, 2)
    args = [*paths, "-c", ssd_job["path"], "--min-prob", "0.3",
            "--profile", "fast"]
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
    for got, want in zip(outputs["port"], outputs["jax"]):
        assert_paired(got["objects"], want["objects"])


@pytest.mark.parametrize("command", [port_predict.predict, web.web])
def test_help_offers_fast(command):
    result = CliRunner().invoke(command, ["--help"])
    assert result.exit_code == 0
    assert "fast" in result.output and "int8" in result.output
    assert "not ported)." not in result.output.split("--profile")[1][:300]


def test_web_server_serves_fast(ssd_job, monkeypatch):
    """``server web --profile fast`` sets the profile's knobs, and the
    server it starts answers a POST with the predictor's objects."""
    captured = {}
    monkeypatch.setattr(web, "run_server",
                        lambda config, **kwargs: captured.update(config))
    result = CliRunner().invoke(web.web, ["-c", ssd_job["path"], "--profile",
                                          "fast", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert captured["model"]["base_network"]["int8_trunk"] is True
    assert captured["model"]["base_network"]["int8_static"] is True
    monkeypatch.undo()

    config = apply_serving_profile(get_config(ssd_job["path"]), "fast")
    httpd = web.run_server(config, port=0, block=False, batch_size=2,
                           device="cpu")
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(6).integers(
        0, 256, (200, 240, 3), dtype=np.uint8)).save(buf, "JPEG")
    try:
        assert httpd.state.ready.wait(120)
        body, content_type = multipart(buf.getvalue())
        request = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/ssd/predict/",
            data=body, method="POST",
            headers={"Content-Type": content_type})
        with urllib.request.urlopen(request, timeout=120) as response:
            status, payload = response.status, json.load(response)
    finally:
        web.stop_server(httpd)
    image = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    want = predicting.PredictorNetwork(config, device="cpu").predict_image(
        image)
    assert status == 200
    assert payload["objects"] == want and len(want) > 0
