"""The port's serving slice end to end against the JAX package (CPU).

Faster R-CNN ResNet-50 v1 (the smallest honest trunk: depth is fixed per
architecture), 3 classes, a 2 x 96 x 128 canvas and the small proposal
budgets of ``tests/test_fasterrcnn_model.py``. The JAX model's own random
init goes through the weight bridge. Without trained batch-norm statistics
the trunk's activations grow to 1e2-1e4, which saturates the softmaxes
at any fixed classifier stddev; so the RPN and RCNN classifier kernels
(and the RCNN box regressor) are rescaled after init until the logits
have a standard deviation of 3 (the deltas 0.5). Score gaps then exceed
float32 noise and the comparison is of real decisions, not of ties.
``min_prob_threshold`` is 0 so every class keeps detections at random
init.

``valid``, labels and order must be equal; boxes agree to 1e-2 px and
probabilities to 1e-5.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from luminoth_tpu.models.fasterrcnn import FasterRCNN as JaxFasterRCNN
from luminoth_tpu.utils.config import Config, get_base_config, to_plain
from luminoth_tpu.utils.predicting import PredictorNetwork as JaxPredictor
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.tasks import Detector
from luminoth_tpu_torch.utils import config as torch_config
from luminoth_tpu_torch.utils import predicting
from luminoth_tpu_torch.utils.checkpoint_io import CheckpointManager
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    init_variables,
    load_flax_variables,
)
from test_torch_isolation import jax_cache_isolation  # noqa: F401

BOX_ATOL = 1e-2  # px
PROB_ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OVERRIDES = {
    "dataset": {"image_preprocessing": {
        "min_size": 96, "max_size": 128,
        "canvas_height": 96, "canvas_width": 128,
    }},
    "model": {
        "network": {"num_classes": 3},
        "base_network": {"architecture": "resnet_v1_50"},
        "rpn": {
            "proposals": {"pre_nms_top_n": 128, "post_nms_top_n": 32},
        },
        "rcnn": {
            "proposals": {
                "total_max_detections": 10, "class_max_detections": 8,
                "min_prob_threshold": 0.0,
            },
        },
    },
}


@pytest.fixture(scope="module")
def config():
    return torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config(OVERRIDES)
    )


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    return (rng.rand(2, 96, 128, 3) * 255).astype(np.float32)


@pytest.fixture(scope="module")
def variables(config, images):
    """JAX random init, with the heads rescaled to unsaturated logits."""
    model = JaxFasterRCNN(config)
    init = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 96, 128, 3)))
    variables = jax.tree_util.tree_map(np.array, init)
    params = variables["params"]

    def port_forward():
        port = load_flax_variables(FasterRCNN(config), variables).eval()
        with torch.inference_mode():
            return port(torch.from_numpy(images))

    # Logits are linear in these kernels (biases are 0). The RPN goes
    # first: its proposals decide the RCNN's inputs.
    rpn = port_forward()["rpn_prediction"]
    params["rpn"]["cls_conv"]["kernel"] *= 3.0 / float(
        rpn["rpn_cls_score"].std()
    )
    rcnn = port_forward()["classification_prediction"]["rcnn"]
    params["rcnn"]["fc_classifier"]["kernel"] *= 3.0 / float(
        rcnn["cls_score"].std()
    )
    params["rcnn"]["fc_bbox"]["kernel"] *= 0.5 / float(
        rcnn["bbox_offsets"].std()
    )
    return variables


def assert_detections_equal(got, want):
    """got/want: dicts of (B, T, ...) arrays: objects, labels, probs, valid."""
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(np.asarray(got["valid"]), valid)
    np.testing.assert_array_equal(
        np.asarray(got["labels"])[valid], np.asarray(want["labels"])[valid]
    )
    np.testing.assert_allclose(
        np.asarray(got["objects"])[valid], np.asarray(want["objects"])[valid],
        rtol=0, atol=BOX_ATOL,
    )
    np.testing.assert_allclose(
        np.asarray(got["probs"])[valid], np.asarray(want["probs"])[valid],
        rtol=0, atol=PROB_ATOL,
    )


class TestFasterRCNN:
    def test_forward_matches_jax(self, config, variables, images):
        want = JaxFasterRCNN(config).apply(
            variables, jnp.asarray(images), train=False
        )
        model = load_flax_variables(FasterRCNN(config), variables).eval()
        with torch.inference_mode():
            got = model(torch.from_numpy(images))

        rpn_want, rpn_got = want["rpn_prediction"], got["rpn_prediction"]
        np.testing.assert_array_equal(
            rpn_got["proposals_valid"].numpy(),
            np.asarray(rpn_want["proposals_valid"]),
        )
        np.testing.assert_allclose(
            rpn_got["proposals"].numpy(), np.asarray(rpn_want["proposals"]),
            rtol=0, atol=BOX_ATOL,
        )
        cls_want = want["classification_prediction"]
        cls_got = {
            k: v.numpy() if torch.is_tensor(v) else v
            for k, v in got["classification_prediction"].items()
        }
        assert set(cls_got) == set(cls_want)
        assert set(rpn_got) == set(rpn_want)
        assert_detections_equal(cls_got, cls_want)
        # Random init must still give real, varied decisions.
        probs = cls_got["probs"][cls_got["valid"]]
        assert probs.min() > 0.0 and len(np.unique(probs)) > 5
        assert len(np.unique(cls_got["labels"])) > 1

    def test_init_variables_have_the_flax_layout(self, config, variables):
        want = flatten_variables(variables)
        got = flatten_variables(init_variables(config, seed=3))
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].shape == value.shape, key
            assert got[key].dtype == np.float32


class TestPredictor:
    def _images(self):
        rng = np.random.RandomState(1)
        return [
            rng.randint(0, 256, (80, 100, 3)).astype(np.uint8),
            rng.randint(0, 256, (120, 90, 3)).astype(np.uint8),
        ]

    def test_predict_batch_matches_jax(self, config, variables):
        want = JaxPredictor(config, variables=variables, mesh=None)
        got = predicting.PredictorNetwork(config, variables, device="cpu")
        images = self._images()
        for pad_to in (None, 4):
            w = want.predict_batch(images, pad_to=pad_to)
            g = got.predict_batch(images, pad_to=pad_to)
            assert len(g) == len(w) == 2
            for g_objs, w_objs in zip(g, w):
                assert len(g_objs) == len(w_objs) > 0
                assert [o["label"] for o in g_objs] == [
                    o["label"] for o in w_objs
                ]
                np.testing.assert_allclose(
                    [o["bbox"] for o in g_objs], [o["bbox"] for o in w_objs],
                    rtol=0, atol=BOX_ATOL,
                )
                np.testing.assert_allclose(
                    [o["prob"] for o in g_objs], [o["prob"] for o in w_objs],
                    rtol=0, atol=PROB_ATOL,
                )

    def test_detector_matches_predictor(self, config, variables, tmp_path):
        path = tmp_path / "config.yml"
        path.write_text(yaml.safe_dump(
            {**OVERRIDES, "model": {**OVERRIDES["model"], "type": "fasterrcnn"}}
        ))
        detector = Detector(config=str(path), variables=variables,
                            device="cpu", prob=0.0)
        images = self._images()
        network = predicting.PredictorNetwork(config, variables, device="cpu")
        assert detector.predict(images) == network.predict_batch(
            images, pad_to=2
        )
        assert detector.predict(images[0]) == network.predict_image(images[0])

    def test_no_device_needs_cuda(self, config, variables, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            predicting.PredictorNetwork(config, variables)

    def test_checkpoint_loading_not_ported(self, tmp_path, monkeypatch):
        """A zoo checkpoint, or no config (the zoo's default, ``accurate``),
        resolves through the zoo (``tests/test_torch_zoo.py`` serves one);
        on an empty zoo both raise the JAX package's ``ValueError``."""
        monkeypatch.setenv("LUMI_HOME", str(tmp_path / "home"))
        monkeypatch.delenv("LUMI_REMOTE_INDEX_URL", raising=False)
        with pytest.raises(ValueError, match="'accurate' not found"):
            Detector(checkpoint="accurate")
        with pytest.raises(ValueError, match="'accurate' not found"):
            Detector()

    def test_predictor_loads_the_newest_checkpoint(self, config, variables,
                                                   tmp_path):
        """Without variables, the predictor loads the newest checkpoint
        under ``train.job_dir`` (here a ``.pt`` in ``job_dir/ckpt``)."""
        model = load_flax_variables(FasterRCNN(config), variables)
        CheckpointManager(str(tmp_path / "ckpt")).save(
            {"step": 3, "model": model.state_dict()}, 3)
        loaded = copy.deepcopy(config)
        loaded.train.job_dir = str(tmp_path)
        images = self._images()
        assert predicting.PredictorNetwork(
            loaded, device="cpu").predict_batch(images) == (
            predicting.PredictorNetwork(config, variables, device="cpu")
            .predict_batch(images))


class TestPackage:
    @pytest.mark.parametrize("model_type", ["fasterrcnn", "ssd"])
    def test_base_config_matches_jax(self, model_type):
        from luminoth_tpu.models import get_model as jax_get_model

        assert to_plain(torch_config.get_base_config(model_type)) == (
            to_plain(get_base_config(jax_get_model(model_type)))
        )

    def test_imports_neither_jax_nor_flax(self):
        # Every module of the port, its trainer and every module that
        # chip_smoke.py imports: none may load the JAX package, JAX or
        # msgpack (the port reads msgpack checkpoints with its own reader).
        code = (
            "import ast, importlib, pkgutil, sys\n"
            "import luminoth_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import luminoth_tpu_torch.train\n"
            "tree = ast.parse(open('chip_smoke.py').read())\n"
            "for node in ast.walk(tree):\n"
            "    if isinstance(node, ast.Import):\n"
            "        for alias in node.names:\n"
            "            importlib.import_module(alias.name)\n"
            "    elif isinstance(node, ast.ImportFrom):\n"
            "        importlib.import_module(node.module)\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('luminoth_tpu', 'jax',\n"
            "                                    'jaxlib', 'flax', 'optax',\n"
            "                                    'msgpack'))\n"
            "print(bad)\n"
        )
        env = dict(os.environ, PYTHONPATH=REPO)
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"
