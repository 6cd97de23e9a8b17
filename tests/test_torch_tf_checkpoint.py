"""The port's TF checkpoint reader and converters against TensorFlow and
the JAX package's converters (CPU).

* ``formats/tf_checkpoint.py`` reads, bitwise, what TensorFlow reads from
  checkpoints it wrote itself: V1 (one ``.ckpt`` file, as in the slim
  tarballs) and V2 bundles, float32/float64/int32/int64 (and V2 half and
  bfloat16), a V1 tensor saved in three slices (TF's own ``Restore`` op
  assembles it; its checkpoint reader refuses sliced V1 files), a
  partitioned V2 variable, a two-shard V2 bundle and a directory with a
  ``checkpoint`` state file. A snappy-compressed block, a bad crc and an
  unsupported dtype are handled; ``chip_smoke.write_tf_bundle`` (the card
  run's writer) writes what TensorFlow reads.
* ``convert-backbone --source slim`` writes the ``.npz`` that the JAX
  ``convert_slim_checkpoint_file`` writes, same keys and equal arrays, for
  ``resnet_v1_50``, ``resnet_v2_50`` and ``vgg_16`` (the slim names at
  small shapes: the converters map names and do not check shapes).
* ``convert-detector`` on a reference-layout Faster R-CNN and SSD
  checkpoint (TensorFlow's V2, with ``Momentum`` slots and
  ``global_step`` beside the weights): its weights loaded into the port
  equal, bitwise, the JAX ``convert_zoo_checkpoint`` msgpack loaded into
  the port. An ambiguous suffix raises as in JAX.
* The converters run in a fresh process without importing TensorFlow.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from click.testing import CliRunner

tf = pytest.importorskip("tensorflow")

import chip_smoke  # noqa: E402
from luminoth_tpu.tools.checkpoint import zoo_convert as jax_zoo  # noqa: E402
from luminoth_tpu.tools.checkpoint.slim_convert import (  # noqa: E402
    convert_slim_checkpoint_file as jax_convert_slim,
)
from luminoth_tpu.utils.config import get_config as jax_get_config  # noqa
from luminoth_tpu_torch.formats import msgpack  # noqa: E402
from luminoth_tpu_torch.formats import tf_checkpoint  # noqa: E402
from luminoth_tpu_torch.models import get_model  # noqa: E402
from luminoth_tpu_torch.tools import checkpoint as zoo  # noqa: E402
from luminoth_tpu_torch.tools.checkpoint import zoo_convert  # noqa: E402
from luminoth_tpu_torch.utils.checkpoint_io import (  # noqa: E402
    load_model_weights,
)
from luminoth_tpu_torch.utils.config import get_config  # noqa: E402
from test_slim_conversion import (  # noqa: E402
    make_slim_resnet_v2_values,
    make_slim_resnet_values,
    make_slim_vgg_values,
)
from test_torch_isolation import (  # noqa: E402,F401
    few_threads,
    jax_cache_isolation,
)
from test_zoo_conversion import (  # noqa: E402
    build_frcnn_ref_values,
    build_ssd_ref_values,
)

tf1 = tf.compat.v1
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def save(values, prefix, version="V2", sliced=None, sharded=False):
    """Write ``{name: array}`` with TensorFlow's own saver. ``sliced``:
    ``(name, shape)`` of a random float32 variable saved in 3 partitions,
    whose value goes to ``values[name]``."""
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    graph = tf1.Graph()
    with graph.as_default():
        names = sorted(values)
        var_map = {}
        for i, name in enumerate(names):
            device = f"/cpu:{i % 2}" if sharded else "/cpu:0"
            with tf1.device(device):
                var_map[name] = tf1.Variable(values[name], name=f"v{i}")
        if sliced is not None:
            parts = list(tf1.get_variable(
                "sliced", shape=sliced[1],
                initializer=tf1.random_normal_initializer(seed=1),
                partitioner=tf1.fixed_size_partitioner(3)))
            var_map[sliced[0]] = parts
        saver = tf1.train.Saver(
            var_list=var_map, sharded=sharded,
            write_version=getattr(tf1.train.SaverDef, version))
        config = tf1.ConfigProto(device_count={"CPU": 2})
        with tf1.Session(graph=graph, config=config) as sess:
            sess.run(tf1.global_variables_initializer())
            if sliced is not None:
                values[sliced[0]] = sess.run(tf1.concat(parts, 0))
            return saver.save(sess, prefix, write_meta_graph=False)


def tf_value(path, name, dtype):
    """What TensorFlow reads: its checkpoint reader, or for a sliced V1
    tensor its ``Restore`` op."""
    reader = tf.train.load_checkpoint(path)
    try:
        return reader.get_tensor(name)
    except (tf.errors.UnimplementedError, NotImplementedError):
        if os.path.isdir(path):
            path = tf.train.latest_checkpoint(path)
        return tf.raw_ops.Restore(file_pattern=path, tensor_name=name,
                                  dt=dtype).numpy()


def mixed_values(version):
    rng = np.random.RandomState(0)
    values = {
        "scope/weights": rng.randn(3, 4, 5).astype(np.float32),
        "scope/biases": rng.randn(5).astype(np.float32),
        "steps/i64": np.arange(-5, 7, dtype=np.int64).reshape(3, 4),
        "steps/i32": np.arange(-3, 3, dtype=np.int32),
        "stats/f64": rng.randn(4),
        "global_step": np.asarray(1234, np.int64),
        "big/w": rng.randn(300, 700).astype(np.float32),
    }
    if version == "V2":  # TF's V1 writer saves neither
        values["half/w"] = rng.randn(5).astype(np.float16)
        values["bf16/w"] = tf.constant(rng.randn(6).astype(np.float32),
                                       dtype=tf.bfloat16).numpy()
    return values


@pytest.mark.parametrize("version", ["V1", "V2"])
def test_reader_equals_tensorflow(tmp_path, version):
    values = mixed_values(version)
    prefix = save(values, str(tmp_path / version / "model.ckpt"), version,
                  sliced=("part/kernel", (10, 3)))
    for path in (prefix, str(tmp_path / version)):
        reader = tf_checkpoint.open_checkpoint(path)
        assert type(reader).version == int(version[1])
        tf_names = tf.train.load_checkpoint(path).get_variable_to_dtype_map()
        assert reader.names() == sorted(tf_names)
        for name, dtype in tf_names.items():
            got = reader.read(name)
            want = tf_value(path, name, dtype)
            if dtype == tf.bfloat16:  # read widened to float32
                want = want.astype(np.float32)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert reader.shape(name) == want.shape
            assert np.array_equal(got, want), name
    assert np.array_equal(reader.read("part/kernel"), values["part/kernel"])


def test_two_shard_bundle(tmp_path):
    values = mixed_values("V2")
    prefix = save(values, str(tmp_path / "model.ckpt"), sharded=True)
    assert os.path.exists(prefix + ".data-00001-of-00002")
    reader = tf_checkpoint.open_checkpoint(prefix)
    tf_reader = tf.train.load_checkpoint(prefix)
    for name in reader.names():
        assert np.array_equal(reader.read(name).astype(np.float32),
                              tf_reader.get_tensor(name).astype(np.float32))


def test_crc_compression_and_dtype_errors(tmp_path):
    prefix = save({"a/w": np.ones((2, 3), np.float32),
                   "s": np.asarray(b"text")}, str(tmp_path / "m.ckpt"))
    reader = tf_checkpoint.open_checkpoint(prefix)
    assert reader.names() == ["a/w", "s"]
    with pytest.raises(ValueError, match="'s' has an unsupported dtype "
                                         r"\(string\)"):
        reader.read("s")
    data = prefix + ".data-00000-of-00001"
    with open(data, "rb") as f:
        raw = bytearray(f.read())
    raw[0] ^= 1
    with open(data, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="'a/w' fails its crc32c"):
        tf_checkpoint.open_checkpoint(prefix).read("a/w")

    index = prefix + ".index"
    with open(index, "rb") as f:
        table = bytearray(f.read())
    table[3] ^= 1
    with open(index, "wb") as f:
        f.write(table)
    with pytest.raises(ValueError, match="fails its crc"):
        tf_checkpoint.open_checkpoint(prefix)
    with pytest.raises(FileNotFoundError):
        tf_checkpoint.open_checkpoint(str(tmp_path / "missing.ckpt"))


def _snappy_literals(raw):
    out = chip_smoke.pb_varint(len(raw))
    for i in range(0, len(raw), 60):
        chunk = raw[i:i + 60]
        out += bytes([(len(chunk) - 1) << 2]) + chunk
    return out


def test_snappy_blocks(tmp_path):
    # a literal, then copies with 1-, 2- and 4-byte offsets, overlapping
    stream = (bytes([12, 1 << 2]) + b"ab" + bytes([(6 - 4) << 2 | 1, 2])
              + bytes([(2 - 1) << 2 | 2, 3, 0]) + bytes([(2 - 1) << 2 | 3])
              + (8).to_bytes(4, "little"))
    assert tf_checkpoint.snappy_decompress(stream) == b"ababababbaab"[:12]

    # A bundle whose data and index blocks are snappy-compressed.
    prefix = chip_smoke.write_tf_bundle(
        str(tmp_path / "m.ckpt"), {"a/w": np.arange(6, dtype=np.float32)})
    entries = list(tf_checkpoint.SSTable(prefix + ".index").items())

    def block(entries, kind):
        body = chip_smoke.table_block(entries)[:-5]
        if kind == 1:
            body = _snappy_literals(body)
        return body + bytes([kind]) + chip_smoke.masked_crc(
            body + bytes([kind])).to_bytes(4, "little")

    def write_table(kind):
        data = block([(k, bytes(v)) for k, v in entries], kind)
        meta = block([], 0)
        handle = chip_smoke.pb_varint(0) + chip_smoke.pb_varint(len(data) - 5)
        index = block([(entries[-1][0], handle)], kind)
        footer = (chip_smoke.pb_varint(len(data))
                  + chip_smoke.pb_varint(len(meta) - 5)
                  + chip_smoke.pb_varint(len(data) + len(meta))
                  + chip_smoke.pb_varint(len(index) - 5)).ljust(40, b"\0")
        with open(prefix + ".index", "wb") as f:
            f.write(data + meta + index + footer + chip_smoke.SSTABLE_MAGIC)

    write_table(1)
    assert np.array_equal(tf_checkpoint.open_checkpoint(prefix).read("a/w"),
                          np.arange(6, dtype=np.float32))
    write_table(2)
    with pytest.raises(ValueError, match="compression type 2"):
        tf_checkpoint.open_checkpoint(prefix)


def test_chip_smoke_writer_is_read_by_tensorflow(tmp_path):
    values = {"a/w": np.random.RandomState(3).randn(3, 4).astype(np.float32),
              "a/w/Momentum": np.ones((3, 4), np.float32),
              "global_step": np.asarray(5, np.int64),
              "i": np.arange(-2, 3, dtype=np.int32)}
    prefix = chip_smoke.write_tf_bundle(str(tmp_path / "m.ckpt-5"), values)
    reader = tf.train.load_checkpoint(prefix)
    assert sorted(reader.get_variable_to_shape_map()) == sorted(values)
    for name, value in values.items():
        got = reader.get_tensor(name)
        assert got.dtype == value.dtype and got.shape == value.shape
        assert np.array_equal(got, value)


def _small(values):
    """The same names at small shapes (the converters map names only)."""
    rng = np.random.RandomState(5)
    return {name: np.asarray(rng.randn(*[min(d, 3) for d in np.shape(value)]),
                             np.asarray(value).dtype)
            for name, value in values.items()}


@pytest.mark.parametrize("architecture,version", [
    ("resnet_v1_50", "V1"), ("resnet_v2_50", "V1"), ("vgg_16", "V2")])
def test_slim_npz_equals_jax(tmp_path, architecture, version):
    if architecture == "vgg_16":
        values = make_slim_vgg_values()
    elif architecture == "resnet_v1_50":
        values = make_slim_resnet_values(50)[1]
    else:
        values = make_slim_resnet_v2_values(50)[1]
    prefix = save(_small(values), str(tmp_path / f"{architecture}.ckpt"),
                  version)
    want_path, got_path = tmp_path / "jax.npz", tmp_path / "port.npz"
    count = jax_convert_slim(prefix, str(want_path), architecture)
    source = "auto" if architecture == "resnet_v1_50" else "slim"
    result = CliRunner().invoke(zoo.checkpoint, [
        "convert-backbone", prefix, str(got_path), "--architecture",
        architecture, "--source", source])
    assert result.exit_code == 0, result.output
    assert result.output == f"Converted {count} arrays to {got_path}.\n"
    with np.load(want_path) as want, np.load(got_path) as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype
            assert np.array_equal(got[key], want[key]), key


def _momentum(values, every=7):
    """A training checkpoint's extras: a ``Momentum`` slot beside every
    ``every``-th weight and the global step."""
    out = dict(values)
    for name in sorted(values)[::every]:
        out[f"{name}/Momentum"] = np.zeros_like(values[name])
    out["global_step"] = np.asarray(100000, np.int64)
    return out


@pytest.fixture(scope="module")
def detector_setting(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo")
    settings = {}
    for model_type, body in (
            ("fasterrcnn", "network: {num_classes: 3}\n  base_network: "
                           "{architecture: resnet_v1_50}"),
            ("ssd", "network: {num_classes: 3}")):
        path = root / f"{model_type}.yml"
        path.write_text(f"model:\n  type: {model_type}\n  {body}\n")
        jax_config = jax_get_config([str(path)])
        values = (build_frcnn_ref_values(jax_config)
                  if model_type == "fasterrcnn"
                  else build_ssd_ref_values(jax_config))
        prefix = save(_momentum(values), str(root / model_type / "model"
                                             ".ckpt-100000"))
        settings[model_type] = (path, jax_config, prefix)
    return root, settings


@pytest.mark.parametrize("model_type", ["fasterrcnn", "ssd"])
def test_convert_detector_equals_jax(detector_setting, model_type):
    root, settings = detector_setting
    path, jax_config, prefix = settings[model_type]
    n_loaded, n_total = jax_zoo.convert_zoo_checkpoint(
        prefix, str(root / f"jax_{model_type}" / "ckpt"), jax_config)
    assert n_loaded == n_total
    out = root / f"port_{model_type}"
    result = CliRunner().invoke(zoo.checkpoint, [
        "convert-detector", prefix, str(out), "-c", str(path)])
    assert result.exit_code == 0, result.output
    assert result.output.startswith(
        f"Converted {n_total}/{n_total} arrays into {out}/ckpt.")

    config = get_config([str(path)])
    port = get_model(model_type)(config)
    load_model_weights(port, torch.load(out / "ckpt" / "ckpt_step_0.pt",
                                        weights_only=True))
    reference = get_model(model_type)(config)
    load_model_weights(reference, msgpack.load(
        str(root / f"jax_{model_type}" / "ckpt" / "ckpt_step_0.msgpack")))
    want = reference.state_dict()
    got = port.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for path_ in root.rglob("ckpt_step_0.*"):
        path_.unlink()


def test_an_ambiguous_suffix_raises_as_in_jax(tmp_path):
    prefix = save({"a/rpn/conv/w": np.ones(2, np.float32),
                   "b/rpn/conv/w": np.ones(2, np.float32),
                   "c/rpn/conv/b": np.zeros(2, np.float32)},
                  str(tmp_path / "m.ckpt"))
    errors = []
    for resolver in (zoo_convert.SuffixResolver, jax_zoo.SuffixResolver):
        with pytest.raises(ValueError) as got:
            resolver(prefix).find("rpn/conv/w")
        errors.append(str(got.value))
        assert resolver(prefix).find("conv/b") == "c/rpn/conv/b"
        assert resolver(prefix).read("missing") is None
    assert errors[0] == errors[1]


NO_TF = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from luminoth_tpu_torch.tools.checkpoint import slim_convert
    from luminoth_tpu_torch.tools.checkpoint.zoo_convert import (
        SuffixResolver)
    slim_convert.convert_slim_checkpoint_file(
        sys.argv[1], sys.argv[2], "vgg_16")
    SuffixResolver(sys.argv[1]).read("conv1/conv1_1/weights")
    print(sorted(n for n in sys.modules if n.split(".")[0] in (
        "tensorflow", "jax", "flax", "luminoth_tpu")))
""").format(repo=REPO)


def test_converters_import_no_tensorflow(tmp_path):
    prefix = save(_small(make_slim_vgg_values()), str(tmp_path / "v.ckpt"))
    out = subprocess.run(
        [sys.executable, "-c", NO_TF, prefix, str(tmp_path / "v.npz")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
