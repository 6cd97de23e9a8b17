"""The port's checkpoint zoo against the JAX package's (CPU).

``luminoth_tpu_torch.tools.checkpoint`` keeps the JAX zoo's home, index
and bundle layout, so one zoo serves both packages. Every case runs under
a temporary ``LUMI_HOME`` (the ``zoo`` fixture, pinned by a test of its
own), never the shared ``~/.luminoth_tpu``. The cases: the CLI lifecycle
on both packages' groups (equal dbs apart from generated ids), a cold
start over ``file://`` of a JAX-made bundle served by the port's
``Detector(checkpoint=alias)`` against the JAX ``Detector`` (detections as
in ``tests/test_torch_slice.py``), a port-made bundle served by the JAX
package, the msgpack writer byte for byte against flax, the flat ``./``
tar the JAX ``import`` mishandles, the extraction guards,
``convert-backbone`` key for key against the JAX converter, and the
pretrained layout guards of ``train``.
"""

import io
import json
import os
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from flax import serialization

from luminoth_tpu.tasks import Detector as JaxDetector
from luminoth_tpu.tools import checkpoint as jax_zoo
from luminoth_tpu.tools.checkpoint import convert as jax_convert
from luminoth_tpu.train import (
    load_pretrained_backbone as jax_load_pretrained_backbone,
)
from luminoth_tpu.utils import checkpoint_io as jax_checkpoint_io
from luminoth_tpu.utils import homedir as jax_homedir
from luminoth_tpu.utils.config import get_config as jax_get_config
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.cli import cli
from luminoth_tpu_torch.formats import msgpack
from luminoth_tpu_torch.models.base.resnet import RESNET_BLOCK_DEFS
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.tasks import Detector
from luminoth_tpu_torch.tools import checkpoint as zoo
from luminoth_tpu_torch.tools.checkpoint import convert
from luminoth_tpu_torch.utils import homedir
from luminoth_tpu_torch.utils.checkpoint_io import CheckpointManager
from luminoth_tpu_torch.utils.config import get_config
from luminoth_tpu_torch.utils.synthetic import write_synthetic_records
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    init_variables,
    load_flax_variables,
)
from test_torch_eval import jax_train_state, rescaled_jax_variables
from test_torch_eval import write_config
from test_torch_isolation import (  # noqa: F401
    few_threads,
    jax_cache_isolation,
    lumi_home_isolation,
)
from test_torch_slice import BOX_ATOL, PROB_ATOL

STEP = 5
PACKAGES = {"jax": jax_zoo.checkpoint, "port": zoo.checkpoint}


@pytest.fixture
def zoo_home(tmp_path, monkeypatch):
    """A temporary ``LUMI_HOME`` and no remote index."""
    home = tmp_path / "home"
    monkeypatch.setenv("LUMI_HOME", str(home))
    monkeypatch.delenv("LUMI_REMOTE_INDEX_URL", raising=False)
    return home


def invoke(group, args):
    result = CliRunner().invoke(group, [str(a) for a in args])
    assert result.exit_code == 0, (result.output, result.exception)
    return result.output


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A small R50 Faster R-CNN: its data, config, rescaled JAX weights, a
    JAX job dir (``.msgpack``) and a port job dir (``.pt``)."""
    root = tmp_path_factory.mktemp("zoo")
    data_dir, _ = write_synthetic_records(
        str(root / "data"), 2, 3, seed=7, height=72, width=96)
    paths, config = {}, None
    for package in ("jax", "port"):
        paths[package] = write_config(root / f"{package}.yml", data_dir,
                                      root / f"{package}_jobs")
    config = get_config(paths["port"])
    variables = rescaled_jax_variables(config)
    jax_checkpoint_io.CheckpointManager(
        str(root / "jax_jobs" / "small" / "ckpt")).save(
        jax_train_state(variables), STEP)
    model = load_flax_variables(FasterRCNN(config), variables)
    CheckpointManager(str(root / "port_jobs" / "small" / "ckpt")).save(
        {"step": STEP, "model": model.state_dict(), "optimizer": {}}, STEP)
    with open(os.path.join(data_dir, "classes.json")) as f:
        labels = json.load(f)
    return {"root": root, "paths": paths, "config": config,
            "variables": variables, "labels": labels}


def query_images():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (80, 100, 3)).astype(np.uint8),
            rng.randint(0, 256, (120, 90, 3)).astype(np.uint8)]


def assert_same_objects(got, want, labels):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert [o["label"] for o in g] == [o["label"] for o in w]
        assert {o["label"] for o in g} <= set(labels)
        np.testing.assert_allclose([o["bbox"] for o in g],
                                   [o["bbox"] for o in w],
                                   rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose([o["prob"] for o in g],
                                   [o["prob"] for o in w],
                                   rtol=0, atol=PROB_ATOL)


# ------------------------------------------------------------- the home


def test_zoo_home_is_the_tmp_path(zoo_home, small):
    """The fixture points the port's home at the tmp path, and ``create``
    under it leaves the default home's index as it was."""
    assert homedir.get_home() == str(zoo_home)
    assert zoo.get_checkpoints_directory().startswith(str(zoo_home))
    default_index = os.path.join(homedir.DEFAULT_HOME, "checkpoints",
                                 "checkpoints.json")

    def snapshot():
        if not os.path.exists(default_index):
            return None
        with open(default_index, "rb") as f:
            return f.read()

    before = snapshot()
    invoke(zoo.checkpoint, ["create", small["paths"]["port"]])
    assert snapshot() == before
    assert os.path.exists(zoo_home / "checkpoints" / "checkpoints.json")


def test_home_is_the_jax_packages(zoo_home, monkeypatch):
    """The port's ``utils/homedir.py`` is a copy: the same default and the
    same ``LUMI_HOME`` override, so one zoo serves both packages."""
    assert homedir.DEFAULT_HOME == jax_homedir.DEFAULT_HOME
    assert homedir.HOME_ENV_VAR == jax_homedir.HOME_ENV_VAR
    assert homedir.get_home() == jax_homedir.get_home() == str(zoo_home)
    monkeypatch.chdir(zoo_home)
    monkeypatch.setenv("LUMI_HOME", "relative")
    assert homedir.get_home(create_if_missing=False) == (
        jax_homedir.get_home(create_if_missing=False))


def test_cli_registers_the_checkpoint_group(zoo_home):
    output = invoke(cli, ["--help"])
    assert "checkpoint" in output
    header = invoke(cli, ["checkpoint", "list"]).splitlines()[0]
    assert header.split() == ["|", "id", "|", "name", "|", "alias", "|",
                              "source", "|", "status", "|"]


# ------------------------------------------------------------ lifecycle


def normalized(db, ids):
    """The db's entries with each generated id (and the URLs holding it)
    replaced by its position in ``ids``."""
    text = json.dumps(db, sort_keys=True)
    for i, checkpoint_id in enumerate(ids):
        text = text.replace(checkpoint_id, f"<id{i}>")
    return json.loads(text)


def test_lifecycle_gives_equal_dbs(small, tmp_path, monkeypatch):
    """create → list/info → edit → export → delete → import → build-index
    → refresh on each package's group, from the same JAX job dir."""
    dbs, bundles = {}, {}
    for package, group in PACKAGES.items():
        home, tars = tmp_path / package / "home", tmp_path / package / "tars"
        tars.mkdir(parents=True)
        monkeypatch.setenv("LUMI_HOME", str(home))
        monkeypatch.delenv("LUMI_REMOTE_INDEX_URL", raising=False)
        invoke(group, ["create", small["paths"]["jax"], "--alias", "one",
                       "-e", "description=first"])
        module = jax_zoo if package == "jax" else zoo
        (entry,) = module.read_checkpoint_db()["checkpoints"]
        checkpoint_id = entry["id"]
        bundle = home / "checkpoints" / checkpoint_id
        with open(bundle / f"ckpt_step_{STEP}.msgpack", "rb") as f:
            bundles[package] = f.read()
        assert sorted(os.listdir(bundle)) == sorted(
            ["checkpoint", "classes.json", "config.yml",
             f"ckpt_step_{STEP}.msgpack"])
        with open(bundle / "config.yml") as f:
            assert yaml.safe_load(f)["train"]["job_dir"] == str(bundle)
        assert checkpoint_id in invoke(group, ["list"])
        assert json.loads(invoke(group, ["info", "one"])) == entry
        invoke(group, ["edit", "one", "--name", "renamed",
                       "-e", "dataset.num_classes=3"])
        invoke(group, ["export", "one", "--output", tars])
        invoke(group, ["delete", "one"])
        assert module.read_checkpoint_db()["checkpoints"] == []
        assert not bundle.exists()
        invoke(group, ["import", tars / f"{checkpoint_id}.tar"])
        assert (bundle / "config.yml").exists()
        invoke(group, ["build-index", tars])
        monkeypatch.setenv("LUMI_REMOTE_INDEX_URL",
                           f"file://{tars / 'index.json'}")
        assert "refreshed" in invoke(group, ["refresh"])
        dbs[package] = normalized(module.read_checkpoint_db(),
                                  [checkpoint_id, str(tmp_path / package)])
    assert dbs["port"] == dbs["jax"]
    (entry,) = dbs["port"]["checkpoints"]
    assert entry["name"] == "renamed" and entry["alias"] == "one"
    # The bundled weights: the same bytes, optimizer state stripped.
    assert bundles["port"] == bundles["jax"]
    state = serialization.msgpack_restore(bundles["port"])
    assert sorted(state) == ["batch_stats", "params", "step"]


# ------------------------------------------------- serving from bundles


def publish(group, config_path, alias, home, zoo_dir, monkeypatch):
    """``create`` + ``export`` + ``build-index`` under ``home`` into
    ``zoo_dir``; returns the index's ``file://`` URL."""
    monkeypatch.setenv("LUMI_HOME", str(home))
    monkeypatch.delenv("LUMI_REMOTE_INDEX_URL", raising=False)
    invoke(group, ["create", config_path, "--alias", alias])
    zoo_dir.mkdir()
    invoke(group, ["export", alias, "--output", zoo_dir])
    invoke(group, ["build-index", zoo_dir])
    return f"file://{zoo_dir / 'index.json'}"


def test_cold_start_serves_a_jax_bundle_like_jax(small, tmp_path,
                                                 monkeypatch):
    """A JAX-made bundle published over ``file://``: a consumer with an
    empty home and only the index URL gets it through the port's
    ``Detector(checkpoint=alias)``, which refreshes the index and
    downloads; its detections are the JAX ``Detector``'s."""
    url = publish(jax_zoo.checkpoint, small["paths"]["jax"], "frcnn",
                  tmp_path / "publisher", tmp_path / "zoo", monkeypatch)
    monkeypatch.setenv("LUMI_HOME", str(tmp_path / "consumer"))
    monkeypatch.setenv("LUMI_REMOTE_INDEX_URL", url)
    detector = Detector(checkpoint="frcnn", prob=0.0, device="cpu")
    (entry,) = zoo.read_checkpoint_db()["checkpoints"]
    assert entry["status"] == "DOWNLOADED"
    got = detector.predict(query_images())
    want = JaxDetector(checkpoint="frcnn", prob=0.0).predict(query_images())
    assert_same_objects(got, want, small["labels"])


def test_port_bundle_is_served_by_jax(small, tmp_path, monkeypatch):
    """A bundle the port made from its ``.pt`` job dir: the JAX package
    reads its config, labels and weights and serves it as the port does,
    through the port's own ``predict --checkpoint`` too."""
    monkeypatch.setenv("LUMI_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("LUMI_REMOTE_INDEX_URL", raising=False)
    invoke(zoo.checkpoint, ["create", small["paths"]["port"], "--alias",
                            "ported"])
    want_vars = flatten_variables(small["variables"])
    got_vars = flatten_variables(jax_checkpoint_io.CheckpointManager(
        jax_zoo.get_checkpoint_config("ported").train.job_dir)
        .latest_state_dict()[0])
    for key, value in want_vars.items():
        np.testing.assert_array_equal(got_vars[key], value, err_msg=key)
    assert jax_zoo.get_checkpoint_class_labels("ported") == small["labels"]
    want = JaxDetector(checkpoint="ported", prob=0.0).predict(query_images())
    got = Detector(checkpoint="ported", prob=0.0, device="cpu").predict(
        query_images())
    assert_same_objects(got, want, small["labels"])

    image = tmp_path / "query.png"
    from PIL import Image

    Image.fromarray(query_images()[0]).save(image)
    out = tmp_path / "pred.jsonl"
    invoke(cli, ["predict", image, "--checkpoint", "ported", "--device",
                 "cpu", "--min-prob", "0", "-f", out])
    objects = json.loads(out.read_text())["objects"]
    assert [o["label"] for o in objects][:3] == [
        o["label"] for o in got[0]][:3]


@pytest.mark.parametrize("detector", [Detector, JaxDetector])
def test_detector_on_an_empty_index_raises(zoo_home, detector):
    with pytest.raises(ValueError, match="not found in index"):
        detector()


# ------------------------------------------------------------- msgpack


def msgpack_tree(rng):
    return {
        "step": np.int32(7), "count": 3, "neg": -300, "rate": 0.5,
        "name": "ckpt", "flag": True, "none": None, "big": 2 ** 40,
        "params": {
            "kernel": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "ids": np.arange(-3, 9, dtype=np.int64).reshape(3, 4),
            "codes": rng.integers(-127, 128, 17).astype(np.int8),
            "scalar": np.float64(2.5), "empty": np.zeros((0, 3), np.float32),
        },
        "list": [1, "two", np.ones(2, np.float32)],
    }


def bf16(array):
    """(JAX bfloat16 array, torch bfloat16 tensor) of the same bits."""
    bits = np.asarray(jnp.asarray(array, jnp.bfloat16))
    return bits, torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("chunk", [None, 64])
def test_msgpack_writer_is_flax(monkeypatch, chunk):
    """Byte for byte flax's ``msgpack_serialize``, read back by flax's
    ``msgpack_restore`` and the port's reader; with a small chunk size,
    the arrays above it (f32 and bf16) go out chunked as flax chunks
    them."""
    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(0)
    tree, port_tree = msgpack_tree(rng), msgpack_tree(
        np.random.default_rng(0))
    tree["params"]["bf16"], port_tree["params"]["bf16"] = bf16(
        rng.standard_normal((9, 7)))
    data = msgpack.serialize(port_tree)
    assert data == serialization.msgpack_serialize(tree)

    by_flax = serialization.msgpack_restore(data)
    by_port = msgpack.restore(data)
    for key in ("kernel", "ids", "codes", "empty"):
        np.testing.assert_array_equal(by_flax["params"][key],
                                      tree["params"][key])
        np.testing.assert_array_equal(by_port["params"][key],
                                      tree["params"][key])
    assert by_flax["params"]["bf16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(by_flax["params"]["bf16"],
                                  tree["params"]["bf16"])
    assert torch.equal(by_port["params"]["bf16"], port_tree["params"]["bf16"])
    assert by_port["step"] == 7 and by_port["big"] == 2 ** 40
    assert by_port["params"]["scalar"] == 2.5
    if chunk is not None:
        raw = msgpack._decode(data)
        assert msgpack._CHUNKED in raw["params"]["kernel"]
        assert msgpack._CHUNKED in raw["params"]["bf16"]


def test_msgpack_dump_round_trips(tmp_path):
    tree = {"step": 3, "params": {"w": np.arange(6, dtype=np.float32)}}
    path = tmp_path / "ckpt_step_3.msgpack"
    msgpack.dump(tree, path)
    np.testing.assert_array_equal(msgpack.load(path)["params"]["w"],
                                  tree["params"]["w"])
    assert os.listdir(tmp_path) == ["ckpt_step_3.msgpack"]


# ------------------------------------------------------------- tarballs


def make_tar(path, build):
    with tarfile.open(path, "w") as tar:
        build(tar)
    return tarfile.open(path)


def add_file(tar, name, data=b"x"):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def test_flat_dot_tar_imports_under_its_metadata_id(zoo_home, small,
                                                    tmp_path):
    """A flat tar whose members are ``./config.yml`` ... (``tar -C dir
    .``) has the single root ``.``; the port treats it as flat, so the
    bundle lands under its metadata id and nothing spills into the
    checkpoints directory."""
    source = tmp_path / "src"
    source.mkdir()
    (source / "config.yml").write_text("model: {type: fasterrcnn}\n")
    (source / "metadata.json").write_text(json.dumps(
        {"id": "flat1234", "alias": "flat"}))
    path = tmp_path / "flat.tar"
    with tarfile.open(path, "w") as tar:
        tar.add(source, arcname=".")
    assert all(n == "." or n.startswith("./")
               for n in tarfile.open(path).getnames())
    invoke(zoo.checkpoint, ["import", path])
    checkpoints = zoo_home / "checkpoints"
    assert sorted(os.listdir(checkpoints)) == ["checkpoints.json",
                                               "flat1234"]
    assert (checkpoints / "flat1234" / "config.yml").exists()
    (entry,) = zoo.read_checkpoint_db()["checkpoints"]
    assert entry["id"] == "flat1234" and entry["source"] == "local"


def test_extraction_rejects_escapes_and_links(tmp_path):
    dest = tmp_path / "out"
    dest.mkdir()
    with make_tar(tmp_path / "a.tar", lambda t: add_file(t, "../evil")) as t:
        with pytest.raises(RuntimeError, match="escapes"):
            zoo._extractall_checked(t, str(dest))
    with make_tar(tmp_path / "b.tar", lambda t: add_file(t, "../evil")) as t:
        with pytest.raises(tarfile.TarError):
            zoo.safe_extractall(t, str(dest))

    def linked(tar):
        link = tarfile.TarInfo("lnk")
        link.type = tarfile.SYMTYPE
        link.linkname = str(tmp_path / "outside")
        tar.addfile(link)
        add_file(tar, "lnk/through")

    with make_tar(tmp_path / "c.tar", linked) as tar:
        with pytest.raises(RuntimeError, match="link"):
            zoo._extractall_checked(tar, str(dest))
    assert not (tmp_path / "outside").exists()
    with make_tar(tmp_path / "d.tar",
                  lambda t: add_file(t, "sub/ok.txt", b"hi")) as tar:
        zoo.safe_extractall(tar, str(dest))
    assert (dest / "sub" / "ok.txt").read_bytes() == b"hi"


# ------------------------------------------------------ convert-backbone


def torchvision_resnet50(seed=0):
    """A seeded state dict in torchvision's ResNet-50 layout."""
    rng = np.random.default_rng(seed)
    state = {}

    def conv(name, cout, cin, k):
        state[f"{name}.weight"] = torch.from_numpy(
            rng.standard_normal((cout, cin, k, k)).astype(np.float32) * 0.05)

    def bn(name, c):
        for leaf, lo, hi in (("weight", 0.5, 1.5), ("bias", -0.2, 0.2),
                             ("running_mean", -0.2, 0.2),
                             ("running_var", 0.5, 1.5)):
            state[f"{name}.{leaf}"] = torch.from_numpy(
                rng.uniform(lo, hi, c).astype(np.float32))
        state[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    depth_in = 64
    for layer, (base, units, _) in enumerate(RESNET_BLOCK_DEFS[50], start=1):
        for unit in range(units):
            prefix = f"layer{layer}.{unit}"
            conv(f"{prefix}.conv1", base, depth_in, 1)
            conv(f"{prefix}.conv2", base, base, 3)
            conv(f"{prefix}.conv3", base * 4, base, 1)
            for k in (1, 2):
                bn(f"{prefix}.bn{k}", base)
            bn(f"{prefix}.bn3", base * 4)
            if unit == 0:
                conv(f"{prefix}.downsample.0", base * 4, depth_in, 1)
                bn(f"{prefix}.downsample.1", base * 4)
            depth_in = base * 4
    state["fc.weight"] = torch.zeros(10, 2048)
    state["fc.bias"] = torch.zeros(10)
    return state


def torchvision_vgg16(seed=0):
    rng = np.random.default_rng(seed)
    state, cin, index = {}, 3, 0
    for reps, cout in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)):
        for _ in range(reps):
            state[f"features.{index}.weight"] = torch.from_numpy(
                rng.standard_normal((cout, cin, 3, 3)).astype(np.float32))
            state[f"features.{index}.bias"] = torch.from_numpy(
                rng.standard_normal(cout).astype(np.float32))
            cin, index = cout, index + 2
        index += 1  # the max-pool
    state["classifier.0.weight"] = torch.zeros(8, 8)
    return state


@pytest.mark.parametrize("architecture,make", [
    ("resnet_v1_50", torchvision_resnet50), ("vgg_16", torchvision_vgg16),
])
def test_convert_backbone_equals_jax(tmp_path, architecture, make):
    pth = tmp_path / "backbone.pth"
    torch.save(make(), pth)
    out = {}
    for package, group in PACKAGES.items():
        out[package] = tmp_path / f"{package}.npz"
        invoke(group, ["convert-backbone", pth, out[package],
                       "--architecture", architecture])
    with np.load(out["port"]) as got, np.load(out["jax"]) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert ("__meta__/layout" in got.files) == (
            architecture.startswith("resnet"))


def pretrained_config(tmp_path, weights, compat, architecture):
    data_dir, _ = write_synthetic_records(
        str(tmp_path / "data"), 2, 3, seed=1, height=72, width=96)
    path = write_config(tmp_path / "cfg.yml", data_dir, tmp_path / "jobs")
    config = get_config(path, override_params=[
        f"model.base_network.architecture={architecture}",
        f"model.base_network.weights={weights}",
        f"model.base_network.torchvision_compat={compat}",
        "model.base_network.fine_tune_from=conv3" if "vgg" in architecture
        else "model.base_network.fine_tune_from=block2",
        "train.save_checkpoint_secs=0", "train.num_epochs=1"])
    return config, path


def test_train_run_loads_torchvision_weights(tmp_path):
    """``train.run`` under ``torchvision_compat`` starts from the converted
    ResNet-50: every converted array that has a place in the model is
    merged, and the batch-norm statistics (which do not train) are still
    the file's after a step."""
    pth, npz = tmp_path / "r50.pth", tmp_path / "r50.npz"
    torch.save(torchvision_resnet50(), pth)
    convert.convert_backbone_file(str(pth), str(npz), "resnet_v1_50")
    config, _ = pretrained_config(tmp_path, npz, True, "resnet_v1_50")
    merged = trainer.load_pretrained_backbone(
        flatten_variables(init_variables(config, seed=0)), config)
    with np.load(npz) as data:
        loaded = [k for k in data.files if k in merged]
        # The trunk stops at block3: its block4 copy has no place (the
        # tail's has); the layout stamp is not a weight.
        assert sorted(set(data.files) - set(loaded)) == sorted(
            ["__meta__/layout"] + [k for k in data.files
                                   if "resnet_v1_50/block4/" in k
                                   and "base_network_tail" not in k])
        assert any("base_network_tail" in k for k in loaded)
        for key in loaded:
            np.testing.assert_array_equal(merged[key], data[key])
    state = trainer.run(config, max_steps=1, device="cpu")
    assert state.step == 1
    assert torch.equal(
        state.model.base_network.resnet_v1_50.block1.unit_1.conv1_bn
        .running_mean,
        torch.from_numpy(np.load(npz)[
            "batch_stats/base_network/resnet_v1_50/block1/unit_1/conv1_bn/"
            "BatchNorm/mean"]))


@pytest.mark.parametrize("layout,compat", [("torchvision", False),
                                           ("slim", True)])
def test_layout_guards_raise_the_jax_errors(tmp_path, layout, compat):
    npz = tmp_path / "w.npz"
    np.savez(npz, **{"__meta__/layout": np.asarray(layout),
                     "params/x": np.zeros(1, np.float32)})
    config, path = pretrained_config(tmp_path, npz, compat, "resnet_v1_50")
    with pytest.raises(ValueError) as got:
        trainer.load_pretrained_backbone({}, config)
    with pytest.raises(ValueError) as want:
        jax_load_pretrained_backbone({}, {}, jax_get_config(
            [path], override_params=[
                f"model.base_network.weights={npz}",
                f"model.base_network.torchvision_compat={compat}"]))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [
    ["convert-backbone", "model.ckpt", "out.npz"],
    ["convert-backbone", "m.pth", "out.npz", "--source", "slim"],
    ["convert-detector", "model.ckpt", "out", "-c", "x.yml"],
    ["download-backbone", "resnet_v1_101"],
])
def test_tensorflow_and_network_commands_raise(zoo_home, args):
    """``download-backbone`` needs the network and raises
    ``NotImplementedError``; the TF-checkpoint commands run without
    TensorFlow now, so on a missing checkpoint (or config) they raise
    ``FileNotFoundError``."""
    result = CliRunner().invoke(zoo.checkpoint, args)
    if args[0] == "download-backbone":
        assert isinstance(result.exception, NotImplementedError)
        assert "network" in str(result.exception)
    else:
        assert isinstance(result.exception, FileNotFoundError)
