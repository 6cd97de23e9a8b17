"""The port's ``train.spatial_shards`` (``parallel/spatial.py``) on the CPU.

The JAX package's 2-D ``(data, space)`` mesh splits each image's height
over ``space`` devices. The port runs a grid of gloo ranks: every band
runs the trunk with halo exchanges, the band's leader gathers the map and
runs the head. Two spawns serve the whole module: two ranks (space 2)
and four (space 4, or data 2 x space 2).

* **Banded trunks against the whole image**, forward and backward (the
  leader applies a random cotangent to each output map): ResNet v1-50 and
  v2-50 at output stride 16, ``torchvision_compat``, Faster R-CNN's VGG-16
  (to ``conv5_3``) at 64 x 64, and SSD's VGG-16 with its extras at
  300 x 300, at space 2 and 4 (the JAX test's 64 x 64 over four bands
  leaves one row per band at stride 16). ``uneven`` has 72 rows: the root
  pool's 17 rows split 4/4/4/5 and block2's 5 rows 1/1/1/2; ``empty`` has
  no output stride, so block3's 2 rows leave two of four bands empty and
  each halo reaches past its neighbour. The ResNet and VGG cases run in
  float64 (R50 v1 in float32 too), SSD's in float32 only. In float64
  every output and every parameter's summed gradient holds ``rtol=1e-5,
  atol=1e-6`` (measured:
  ~1e-15, the exchange is exact). In float32 the bands' convolutions sum
  in another order than the whole map's (oneDNN picks kernels by shape):
  about 0.3% of block3's elements miss an absolute 1e-6, so float32 holds
  ``rtol=1e-5`` with ``atol`` 1e-6 of the map's largest magnitude
  (measured: 4e-7 of it), and the gradients 1e-5 of theirs (SSD's first
  conv sums 300 x 300 positions: 4e-6 measured).
* **One Faster R-CNN step against the JAX package's own 2-D mesh step**:
  ``make_train_step(model, optax.sgd(1e-3), mesh=make_mesh(num_devices=4,
  space=2))`` on 4 of the suite's 8 CPU devices, at the JAX test's
  setting (ResNet-50 v1, 3 classes, 2 x 64 x 64, pre/post NMS 64/16,
  minibatches 16/8, every parameter trained, no L2 term) with fixed
  target keys whose uniforms the port gets (``test_torch_train``). The
  port trains data 1 x space 2 and data 2 x space 2. Losses and gradient
  norm to ``rtol=1e-4``, the JAX test's bound; the gradients, read from
  the SGD update of every parameter, to ``GRAD_RTOL`` relative (as one
  vector).
* **SSD, and Faster R-CNN with ``train_batch_norm`` and ``remat``**, one
  step at space 2 against the port's one-process step, with the
  tolerances of ``tests/test_torch_parallel.py`` and, under batch
  statistics, ``tests/test_torch_parallel_mesh.py``'s: the losses, each
  head tensor's move, the parameters' moves together and each running
  statistic's move, each on its own. The batch-norm step runs again with
  a planted fault, each band normalised by its own moments
  (``local_band_statistics``): the same check must refuse it.
* **``train.run``** with ``spatial_shards: 2`` over ``device=["cpu",
  "cpu"]`` and over a two-process ``LUMI_COORDINATOR`` group: only rank
  0 writes the checkpoint, and the loss is the one-process run's; a device
  count or a canvas height that 2 does not divide raises ``ValueError``.
"""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from luminoth_tpu.parallel.mesh import make_mesh, replicate_sharding
from luminoth_tpu.train import TrainState, _device_batch, make_train_step
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.parallel import distributed, spatial
from luminoth_tpu_torch.parallel.distributed import spawn_ranks
from luminoth_tpu_torch.utils.synthetic import write_synthetic_records
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    init_variables,
    nest_variables,
    torch_state_from_flax,
)
from test_torch_isolation import (  # noqa: F401
    few_threads,
    jax_cache_isolation,
    lumi_home_isolation,
)
from test_torch_parallel import SSD_LOSS_RTOL, _relative
from test_torch_train import (
    PARAM_ATOL,
    PARAM_RTOL,
    KeyedFasterRCNN,
    port_priorities,
)
from test_torch_train_knobs import (
    ALL_MOVES_RTOL,
    HEAD_MOVE_RTOL,
    KNOBS_LOSS_RTOL,
    STATS_MOVE_RTOL,
)
from torch_parallel_worker import (
    RANK_TIMEOUT_S,
    jax_mesh_batch,
    jax_mesh_config,
    rank_spatial,
    ssd_batch,
    ssd_config,
    step_config,
    train_batch,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
MESH_LOSS_RTOL = 1e-4  # the JAX package's 2-D mesh test
GRAD_RTOL = 1e-4
BAND_RTOL, BAND_ATOL = 1e-5, 1e-6
# float32 gradients: of the largest magnitude (a 300 x 300 first conv's
# weight gradient sums 90000 positions in another order: 4e-6 measured).
F32_GRAD_ATOL = 1e-5
R50 = {"architecture": "resnet_v1_50", "output_stride": 16}


def _images(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(
        np.float32)


# id: (space, case)
BANDS = {
    "r50_v1-s2": (2, {"config": R50, "shape": (2, 64, 64, 3)}),
    "r50_v1-s4": (4, {"config": R50, "shape": (2, 64, 64, 3)}),
    "r50_v1-uneven-s4": (4, {"config": R50, "shape": (1, 72, 40, 3)}),
    "r50_v1-empty-s4": (4, {"config": {"architecture": "resnet_v1_50"},
                            "shape": (1, 64, 48, 3)}),
    "r50_v2-s2": (2, {"config": {**R50, "architecture": "resnet_v2_50"},
                      "shape": (1, 64, 64, 3)}),
    "r50_v2-s4": (4, {"config": {**R50, "architecture": "resnet_v2_50"},
                      "shape": (1, 64, 64, 3)}),
    "torchvision_compat-s2": (2, {"config": {**R50,
                                             "torchvision_compat": True},
                                  "shape": (1, 64, 64, 3)}),
    "torchvision_compat-s4": (4, {"config": {**R50,
                                             "torchvision_compat": True},
                                  "shape": (1, 72, 40, 3)}),
    "vgg_16-s2": (2, {"config": {"architecture": "vgg_16"},
                      "shape": (1, 64, 64, 3)}),
    "vgg_16-s4": (4, {"config": {"architecture": "vgg_16"},
                      "shape": (1, 72, 40, 3)}),
    "ssd-s2": (2, {"ssd": True, "shape": (1, 300, 300, 3)}),
    "ssd-s4": (4, {"ssd": True, "shape": (1, 300, 300, 3)}),
}
# SSD at 300 x 300 runs in float32 only (float64 costs minutes here).
FLOAT32 = ("r50_v1-s2", "r50_v1-s4", "ssd-s2", "ssd-s4")
CASES = [(name, "float64") for name in BANDS if not name.startswith(
    "ssd")] + [(name, "float32") for name in FLOAT32]


@pytest.fixture(scope="module")
def mesh_setting():
    """The JAX test's setting: config, variables (the port's init, seed
    0), batch and the uniforms of the fixed target keys."""
    config = jax_mesh_config()
    variables = nest_variables(flatten_variables(init_variables(config,
                                                                seed=0)))
    return config, variables, jax_mesh_batch(), port_priorities(2, 192, 16)


def step_jobs():
    """``(config, variables, batch)`` of the SSD and the batch-norm +
    remat steps."""
    knobs = step_config(train_batch_norm=True)
    knobs.model.base_network.remat = True
    return {"ssd": (ssd_config(), init_variables(ssd_config(), seed=0),
                    ssd_batch()),
            "knobs": (knobs, init_variables(knobs, seed=0), train_batch())}


# The space-2 steps against one process: id -> (job, planted fault).
STEP_JOBS = {"ssd": ("ssd", None), "knobs": ("knobs", None),
             "knobs-local_band_statistics": ("knobs",
                                             "local_band_statistics")}
# Their limits under batch statistics, each reading on its own.
KNOBS_LIMITS = {"loss": KNOBS_LOSS_RTOL, "head": HEAD_MOVE_RTOL,
                "params": ALL_MOVES_RTOL, "stats": STATS_MOVE_RTOL}


def _spawn(count, bands, mesh_setting, extra=()):
    config, variables, batch, priorities = mesh_setting
    tasks = [("band", case) for case in bands.values()]
    tasks.append(("steps", config, variables, batch, priorities, 2, 1))
    tasks.extend(extra)
    return spawn_ranks(rank_spatial, ["cpu"] * count, threads=1,
                       args=(tasks,), timeout=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks(mesh_setting):
    """Both spawns: two ranks (the space-2 band cases, the JAX setting at
    data 1 x space 2, the SSD and knob steps) and four (the space-4 band
    cases, the JAX setting at data 2 x space 2)."""
    bands = {}
    for i, (name, dtype) in enumerate(CASES):
        space, case = BANDS[name]
        bands.setdefault(space, {})[name, dtype] = dict(
            case, dtype=dtype, images=_images(case["shape"], i),
            rtol=BAND_RTOL, seed=100 + i)
    jobs = step_jobs()
    two = _spawn(2, bands[2], mesh_setting, extra=[
        ("steps",) + jobs[name] + (None, 2, 1, fault)
        for name, fault in STEP_JOBS.values()])
    four = _spawn(4, bands[4], mesh_setting)
    out = {"band": {}}
    for space, spawned in ((2, two), (4, four)):
        for key, result in zip(bands[space], spawned[0]):
            out["band"][key] = result
        out["mesh", space] = spawned[0][len(bands[space])]
    out["jobs"] = dict(zip(STEP_JOBS, two[0][-len(STEP_JOBS):]))
    out["follower_jobs"] = dict(zip(STEP_JOBS, two[1][-len(STEP_JOBS):]))
    return out


@pytest.mark.parametrize("name,dtype", CASES,
                         ids=[f"{n}-{d}" for n, d in CASES])
def test_banded_trunk_equals_the_whole_image(ranks, name, dtype):
    result = ranks["band"][name, dtype]
    assert len(result["out"]) == (6 if BANDS[name][1].get("ssd") else 1)
    for got, want in zip(result["out"], result["want"]):
        assert got.shape == want.shape
        scale = 1.0 if dtype == "float64" else float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=BAND_RTOL, atol=BAND_ATOL * scale)
    assert result["grad_excess"]
    for key, excess in result["grad_excess"].items():
        atol = BAND_ATOL if dtype == "float64" else (
            F32_GRAD_ATOL * result["grad_scale"][key])
        assert excess <= atol, key


def jax_mesh_step(config, variables, batch):
    """One step of the JAX package's ``make_train_step`` on a data 2 x
    space 2 mesh: metrics and parameters after."""
    tx = optax.sgd(1e-3)
    params = variables["params"]
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=tx.init(params),
                       batch_stats=variables["batch_stats"])
    mesh = make_mesh(num_devices=4, space=2)
    step = make_train_step(KeyedFasterRCNN(config), tx, mesh=mesh)
    state, metrics = step(jax.device_put(state, replicate_sharding(mesh)),
                          _device_batch(batch, mesh), jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            torch_state_from_flax({"params": jax.tree_util.tree_map(
                np.asarray, state.params)}))


@pytest.fixture(scope="module")
def jax_reference(mesh_setting):
    config, variables, batch, _ = mesh_setting
    return jax_mesh_step(config, variables, batch)


@pytest.mark.parametrize("space", [2, 4], ids=["1x2", "2x2"])
def test_step_matches_the_jax_mesh(ranks, mesh_setting, jax_reference,
                                   space):
    _, variables, _, _ = mesh_setting
    want_metrics, want_params = jax_reference
    got = ranks["mesh", space]
    for key, value in want_metrics.items():
        np.testing.assert_allclose(got["metrics"][0][key], value,
                                   rtol=MESH_LOSS_RTOL, err_msg=key)
    start = torch_state_from_flax(variables)
    got_moves = torch.cat([(got["state"][k] - start[k]).double().flatten()
                           for k in want_params])
    want_moves = torch.cat([(want_params[k] - start[k]).double().flatten()
                            for k in want_params])
    assert _relative(got_moves, want_moves) <= GRAD_RTOL


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process step of each job of ``step_jobs``, by name
    (each computed once)."""
    from torch_parallel_worker import port_steps

    done = {}

    def get(name):
        if name not in done:
            done[name] = port_steps(*step_jobs()[name], steps=1)
        return done[name]

    return get


def knobs_readings(got, one, start):
    """The relative errors of a banded batch-statistics step ``got``
    against the one-process step ``one`` from the state ``start``, by
    group (see ``KNOBS_LIMITS``): the largest over the losses, over each
    head tensor's move and over each running statistic's move, and the
    parameters' moves together."""
    readings = {"loss": max(abs(got["metrics"][0][k] - v) / abs(v)
                            for k, v in one["metrics"][0].items())}
    state, want = got["state"], one["state"]
    moves = {k: (state[k] - start[k], want[k] - start[k]) for k in want
             if k in start and not torch.equal(want[k], start[k])}
    stats = [k for k in moves if k.endswith(("running_mean", "running_var"))]
    params = {k: m for k, m in moves.items() if k not in stats}
    readings["head"] = max(_relative(*params[k]) for k in params
                           if k.startswith(("rpn.", "rcnn.")))
    readings["params"] = _relative(
        torch.cat([m.flatten() for m, _ in params.values()]),
        torch.cat([m.flatten() for _, m in params.values()]))
    readings["stats"] = max(_relative(*moves[k]) for k in stats)
    return readings, stats


@pytest.mark.parametrize("name", ["ssd", "knobs"])
def test_two_band_steps_equal_one_process(ranks, one_process, name):
    job = step_jobs()[name]
    one = one_process(name)
    got = ranks["jobs"][name]
    rtol = SSD_LOSS_RTOL if name == "ssd" else KNOBS_LOSS_RTOL
    for metrics, want in zip(got["metrics"], one["metrics"]):
        assert set(metrics) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(metrics[key], value, rtol=rtol,
                                       err_msg=key)
    assert got["metrics"] == ranks["follower_jobs"][name]["metrics"]
    state, want = got["state"], one["state"]
    if name == "ssd":
        for key, value in want.items():
            np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=key)
        return
    readings, stats = knobs_readings(got, one, torch_state_from_flax(job[1]))
    assert any("block1" in k and "running_mean" in k for k in stats)
    for key, limit in KNOBS_LIMITS.items():
        assert readings[key] <= limit, (key, readings)


def test_per_band_statistics_are_refused(ranks, one_process):
    """The planted ``local_band_statistics`` fault (each band normalised
    by its own moments) fails the batch-statistics step's check."""
    job = step_jobs()["knobs"]
    readings, _ = knobs_readings(
        ranks["jobs"]["knobs-local_band_statistics"], one_process("knobs"),
        torch_state_from_flax(job[1]))
    assert readings["stats"] > KNOBS_LIMITS["stats"], readings


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    write_synthetic_records(str(root / "data"), count=4, num_classes=3,
                            seed=0, height=64, width=64)
    return root


def _run_config(root, run_name, **prep):
    config = copy.deepcopy(jax_mesh_config())
    config.train.update({
        "job_dir": str(root / "jobs"), "run_name": run_name,
        "batch_size": 2, "seed": 3, "save_summaries_steps": 1,
        "spatial_shards": 2})
    config.dataset.dir = str(root / "data")
    config.dataset.image_preprocessing.update({
        "min_size": 64, "max_size": 64, "canvas_height": 64,
        "canvas_width": 64, **prep})
    return config


def _checkpoints(run_dir):
    return sorted(os.listdir(run_dir / "ckpt"))


def test_run_over_a_device_list(records):
    """Two spawned ranks, one band each: the chief's checkpoint only, and
    the one-process run's loss."""
    config = _run_config(records, "bands")
    state = trainer.run(config, max_steps=1, device=["cpu", "cpu"])
    assert state.step == 1
    assert _checkpoints(records / "jobs" / "bands") == ["ckpt_step_1.pt"]
    plain = _run_config(records, "plain")
    plain.train.spatial_shards = 1
    want = trainer.run(plain, max_steps=1, device="cpu")
    np.testing.assert_allclose(state.history[0]["total_loss"],
                               want.history[0]["total_loss"], rtol=1e-4)
    for path in records.rglob("ckpt_step_*"):
        path.unlink()


def test_run_joins_a_coordinator_grid(records, tmp_path):
    """``LUMI_COORDINATOR`` with two processes: one data x two space
    ranks; the chief writes the checkpoint and both log its loss."""
    config = _run_config(records, "env")
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(config))))
    port = distributed.free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("LUMI_COORDINATOR", "LUMI_DISTRIBUTED",
                                    "RANK", "WORLD_SIZE", "MASTER_"))}
        env.update(distributed.worker_env("127.0.0.1", port, 2, rank))
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "luminoth_tpu_torch.train", "-c",
             str(path), "--max-steps", "1", "--device", "cpu"], cwd=REPO,
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    logs = []
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=RANK_TIMEOUT_S)
            assert proc.returncode == 0, err[-3000:]
            logs.append(err)
    finally:
        for proc in procs:
            proc.kill()
    assert all("1 data x 2 space" in log for log in logs)
    losses = [[line for line in log.splitlines() if "train_loss" in line]
              for log in logs]
    assert len(losses[0]) == 1
    assert losses[0][0].split("train_loss:")[1].split()[0] == (
        losses[1][0].split("train_loss:")[1].split()[0])
    assert _checkpoints(records / "jobs" / "env") == ["ckpt_step_1.pt"]
    for path in records.rglob("ckpt_step_*"):
        path.unlink()


@pytest.mark.parametrize("device,prep,match", [
    (["cpu"] * 3, {}, "device count"),
    ("cpu", {}, "device count"),
    (["cpu"] * 2, {"canvas_height": None, "fixed_height": 65,
                   "fixed_width": 64}, "canvas height of 65"),
], ids=["three-devices", "one-device", "odd-canvas"])
def test_what_two_bands_cannot_split_raises(records, device, prep, match):
    config = _run_config(records, "bad", **prep)
    with pytest.raises(ValueError, match=match):
        trainer.run(config, max_steps=1, device=device)


def test_grid_layout_follows_the_jax_mesh():
    """Rank r is band r % space of row block r // space, as
    ``make_mesh``'s ``reshape(data, space)``; the bands follow the global
    height, uneven where it does not split."""
    grid = [spatial.make_grid(r, 8, 4) for r in range(8)]
    assert [(g.data_index, g.space_index) for g in grid] == [
        (d, s) for d in range(2) for s in range(4)]
    want = np.arange(8).reshape(2, 4)
    assert [[g.rank for g in grid if g.data_index == d] for d in range(2)
            ] == want.tolist()
    assert [g.leader for g in grid] == [0] * 4 + [4] * 4
    assert spatial.bands(17, 4) == ((0, 4), (4, 8), (8, 12), (12, 17))
    assert spatial.bands(2, 4) == ((0, 0), (0, 1), (1, 1), (1, 2))
    with pytest.raises(ValueError, match="divisible"):
        spatial.make_grid(0, 6, 4)
    image = np.arange(2 * 8).reshape(2, 8)
    assert spatial.image_band(image, 1, 4).tolist() == [[2, 3], [10, 11]]
    with pytest.raises(ValueError, match="does not split"):
        spatial.image_band(image[:, :6], 0, 4)
