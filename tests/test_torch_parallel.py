"""The port's data parallelism on the CPU: gloo, two spawned ranks.

* Two train steps over two ranks (``make_train_step`` with the group, one
  image each) against two steps of one process on the global batch of
  two, Faster R-CNN ResNet-50 v1 at 96 x 128 (the smallest Faster R-CNN
  of the port: the ResNet widths are fixed), the draws from
  ``train.step_generator``. The two images hold 3 and 2 boxes, so the
  ranks' masked-mean counts differ (asserted); each rank divides by the
  global count and the gradients are summed. With fixed batch-norm
  statistics the losses and the gradient norm agree to 1e-5 relative and
  the parameters to atol 1e-6 + rtol 1e-5,
  the tolerances of ``tests/test_torch_train.py``'s step test (measured:
  1.4e-6 and 1.2e-7). With ``train_batch_norm`` the statistics are the
  global batch's, summed in float32 over the ranks; the sums' rounding
  differs from one process's mean, and batch statistics amplify it
  (``tests/test_torch_train_knobs.py`` explains by how much), so the
  tolerances are that module's: losses and norm to 5e-3 relative, the
  heads' moves to 1e-2, all moves together to 0.2. SSD (its loss a mean
  of per-image terms, through the same code path) trains every layer, so
  each weight gradient sums one image twice on the ranks where one
  process sums two at once, in kernels oneDNN picks by batch size: the
  gradient norm agrees to 2.1e-5 (measured), held to 1e-4, and the losses
  too; its parameters to the step test's tolerances.
* ``train.run(device=["cpu", "cpu"])``: only the chief writes the
  checkpoint, the summaries and the journal line; both ranks log the same
  losses; a resume leaves rank 1 with the chief's restored step and
  values.
* ``initialize_from_env`` over ``LUMI_COORDINATOR`` and over
  ``LUMI_DISTRIBUTED_AUTO`` with the launcher's ``env://`` variables, in
  two processes each; ``worker_env``; ``train.run`` under a one-process
  ``LUMI_COORDINATOR`` group.
* Eval and ``PredictorNetwork`` over ``["cpu", "cpu"]`` against one
  device running the same rows, bitwise (the CPU's convolutions are not
  batch-size invariant, so a batch of two on one device differs in the
  last bits; its losses are held to 1e-4).

The JAX 2-device mesh step is in ``tests/test_torch_parallel_mesh.py``.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from luminoth_tpu_torch import eval as port_eval
from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
from luminoth_tpu_torch.parallel import distributed
from luminoth_tpu_torch.parallel.distributed import spawn_ranks
from luminoth_tpu_torch.parallel.mesh import (
    batch_shard,
    concat_rows,
    replicate,
)
from luminoth_tpu_torch.utils.predicting import PredictorNetwork
from luminoth_tpu_torch.utils.synthetic import write_synthetic_records
from luminoth_tpu_torch.utils.weights import (
    init_variables,
    load_flax_variables,
)
from test_torch_isolation import few_threads, lumi_home_isolation  # noqa: F401
from torch_parallel_worker import (
    RANK_TIMEOUT_S,
    checksum,
    port_steps,
    rank_read,
    rank_run,
    rank_steps,
    ssd_batch,
    ssd_config,
    step_config,
    train_batch,
)

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
KNOBS_LOSS_RTOL = 5e-3
SSD_LOSS_RTOL = 1e-4
HEAD_MOVE_RTOL, ALL_MOVES_RTOL = 1e-2, 0.2
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RANK_THREADS = 1


def _relative(got, want):
    return float((got - want).norm() / want.norm())


SETTINGS = ("fixed_statistics", "train_batch_norm", "ssd")


def setting_job(setting):
    """``(config, variables, batch)`` of a step test's setting."""
    if setting == "ssd":
        config = ssd_config()
        return config, init_variables(config, seed=0), ssd_batch()
    config = step_config(setting == "train_batch_norm")
    return config, init_variables(config, seed=0), train_batch()


@pytest.fixture(scope="module")
def rank_results():
    """Every setting's steps in one pair of spawned ranks, by setting."""
    ranks = spawn_ranks(rank_steps, ["cpu", "cpu"], threads=RANK_THREADS,
                        args=([setting_job(s) for s in SETTINGS],),
                        timeout=RANK_TIMEOUT_S)
    return {setting: [rank[i] for rank in ranks]
            for i, setting in enumerate(SETTINGS)}


@pytest.mark.parametrize("setting", SETTINGS)
def test_two_rank_steps_equal_one_process(setting, rank_results):
    """SSD's loss is a mean of per-image terms: the same code path (each
    rank's share of the global mean, gradients summed) gives it."""
    train_batch_norm = setting == "train_batch_norm"
    config, variables, batch = setting_job(setting)
    one = port_steps(config, variables, batch)
    ranks = rank_results[setting]

    # The ranks' own denominators differ; each divided by their sum.
    for step in range(2 if setting != "ssd" else 0):
        local = [[c[0] for c in rank["counts"][step]] for rank in ranks]
        total = [[c[1] for c in rank["counts"][step]] for rank in ranks]
        assert len(local[0]) == 4 and total[0] == total[1]
        assert local[0] != local[1]
        assert [a + b for a, b in zip(*local)] == total[0]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for key in ranks[0]["state"]:
        assert torch.equal(ranks[0]["state"][key], ranks[1]["state"][key])

    loss_rtol = {"fixed_statistics": LOSS_RTOL, "ssd": SSD_LOSS_RTOL,
                 "train_batch_norm": KNOBS_LOSS_RTOL}[setting]
    for got, want in zip(ranks[0]["metrics"], one["metrics"]):
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=loss_rtol,
                                       err_msg=key)
    got, want = ranks[0]["state"], one["state"]
    if not train_batch_norm:
        for key, value in want.items():
            np.testing.assert_allclose(
                got[key].numpy(), value.numpy(), rtol=PARAM_RTOL,
                atol=PARAM_ATOL, err_msg=key)
        return
    from luminoth_tpu_torch.utils.weights import torch_state_from_flax

    start = torch_state_from_flax(variables)
    moves = {k: (got[k] - start[k], want[k] - start[k]) for k in want
             if k in start and not torch.equal(want[k], start[k])}
    for key, (rank_move, one_move) in moves.items():
        if key.startswith(("rpn.", "rcnn.")):
            assert _relative(rank_move, one_move) <= HEAD_MOVE_RTOL, key
    assert _relative(torch.cat([m.flatten() for m, _ in moves.values()]),
                     torch.cat([m.flatten() for _, m in moves.values()])
                     ) <= ALL_MOVES_RTOL
    assert any("running_mean" in k for k in moves)


def _run_config(tmp_path, **train):
    config = step_config()
    config.train.update({
        "job_dir": str(tmp_path / "jobs"), "run_name": "dp", "batch_size": 2,
        "seed": 3, "save_summaries_steps": 1, **train})
    config.dataset.dir = str(tmp_path / "data")
    config.dataset.image_preprocessing.update({
        "min_size": 96, "max_size": 128, "canvas_height": 96,
        "canvas_width": 128})
    return config


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    write_synthetic_records(str(root / "data"), count=4, num_classes=3,
                            seed=0, height=80, width=100)
    return root


def test_run_over_two_devices_writes_once_and_resumes(records,
                                                       lumi_home_isolation):
    config = _run_config(records)
    ranks = spawn_ranks(rank_run, ["cpu", "cpu"], threads=RANK_THREADS,
                        args=(config, 1), timeout=RANK_TIMEOUT_S)
    assert [r["step"] for r in ranks] == [1, 1]
    assert ranks[0]["history"] == ranks[1]["history"]
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    run_dir = records / "jobs" / "dp"
    assert sorted(os.listdir(run_dir / "ckpt")) == ["ckpt_step_1.pt"]
    assert len(list(run_dir.glob("events.out.tfevents.*"))) == 1
    with open(os.path.join(lumi_home_isolation, "runs.json")) as f:
        assert len(f.read().splitlines()) == 1

    # The chief restores step 1; rank 1 starts fresh and takes its state.
    saved = torch.load(run_dir / "ckpt" / "ckpt_step_1.pt",
                       weights_only=True)
    resumed = spawn_ranks(rank_run, ["cpu", "cpu"], threads=RANK_THREADS,
                          args=(_run_config(records), 2),
                          timeout=RANK_TIMEOUT_S)
    assert [r["step"] for r in resumed] == [2, 2]
    assert resumed[0]["checksum"] == resumed[1]["checksum"]
    assert resumed[0]["checksum"] != ranks[0]["checksum"]
    latest = torch.load(run_dir / "ckpt" / "ckpt_step_2.pt",
                        weights_only=True)
    assert latest["step"] == 2 and saved["step"] == 1
    assert resumed[1]["checksum"] == checksum(latest["model"])

    # run() over a device list returns the chief's state.
    state = trainer.run(_run_config(records, run_name="list"),
                        max_steps=1, device=["cpu", "cpu"])
    assert state.step == 1 and len(state.history) == 1
    assert state.history[0]["total_loss"] == pytest.approx(
        ranks[0]["history"][0]["total_loss"], rel=LOSS_RTOL)
    for path in records.rglob("ckpt_step_*"):
        path.unlink()


def test_unseeded_ranks_read_the_same_batches(tmp_path):
    """With ``train.seed`` unset the ranks shuffle with the chief's draw:
    every step, both read the same global batch (8 records: two steps of
    two from independent shuffles agree once in 1680)."""
    write_synthetic_records(str(tmp_path / "data"), count=8, num_classes=3,
                            seed=0, height=80, width=100)
    config = _run_config(tmp_path, seed=None, no_log=True)
    assert config.train.random_shuffle
    ranks = spawn_ranks(rank_read, ["cpu", "cpu"], threads=RANK_THREADS,
                        args=(config, 2), timeout=RANK_TIMEOUT_S)
    assert len(ranks[0]) == 2 and all(len(b) == 2 for b in ranks[0])
    assert ranks[0] == ranks[1]


def test_spawned_training_sets_no_join_deadline(tmp_path, monkeypatch):
    """A data-parallel ``train.run`` may train for days: its join waits
    for the ranks with no deadline (``spawn_ranks``'s default)."""
    import inspect

    calls = []

    def fake_spawn(*args, **kwargs):
        calls.append(kwargs)
        raise RuntimeError("spawn recorded")

    monkeypatch.setattr(trainer, "spawn_ranks", fake_spawn)
    with pytest.raises(RuntimeError, match="spawn recorded"):
        trainer.run(_run_config(tmp_path), max_steps=1,
                    device=["cpu", "cpu"])
    assert len(calls) == 1 and calls[0].get("timeout") is None
    assert inspect.signature(spawn_ranks).parameters[
        "timeout"].default is None


def test_spatial_shards_still_raise_with_a_device_list(tmp_path):
    """Two devices form a data 1 x space 2 grid
    (``tests/test_torch_spatial.py``), but not over a canvas height that 2
    does not divide: ``ValueError`` before any rank starts, as the JAX
    package's ``device_put`` raises."""
    config = _run_config(tmp_path, spatial_shards=2)
    config.dataset.image_preprocessing.update(
        {"canvas_height": None, "fixed_height": 97, "fixed_width": 128})
    with pytest.raises(ValueError, match="canvas height of 97"):
        trainer.run(config, max_steps=1, device=["cpu", "cpu"])


ENV_PROBE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import torch, torch.distributed as dist
    from luminoth_tpu_torch.parallel import (
        initialize_from_env, is_chief, world)
    formed = initialize_from_env()
    value = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(value)
    print(json.dumps({{"formed": formed, "world": list(world()),
                      "chief": is_chief(),
                      "backend": dist.get_backend(),
                      "sum": float(value)}}))
    dist.destroy_process_group()
""").format(repo=REPO)


@pytest.mark.parametrize("mode", ["coordinator", "auto"])
def test_initialize_from_env_forms_the_group(mode):
    port = distributed.free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith(
            ("LUMI_COORDINATOR", "LUMI_DISTRIBUTED", "RANK", "WORLD_SIZE",
             "MASTER_"))}
        if mode == "coordinator":
            env.update(distributed.worker_env("127.0.0.1", port, 2, rank))
        else:
            env.update(distributed.worker_env_auto())
            env.update({"RANK": str(rank), "WORLD_SIZE": "2",
                        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                        "LOCAL_RANK": str(rank)})
        env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", ENV_PROBE], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    reports = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err[-3000:]
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    assert [r["world"] for r in reports] == [[0, 2], [1, 2]]
    assert [r["chief"] for r in reports] == [True, False]
    assert all(r["formed"] and r["backend"] == "gloo" and r["sum"] == 3.0
               for r in reports)


def test_worker_env_and_the_environment_switches():
    assert distributed.worker_env("10.0.0.2", 8476, 4, 3) == {
        "LUMI_COORDINATOR": "10.0.0.2:8476", "LUMI_NUM_PROCESSES": "4",
        "LUMI_PROCESS_ID": "3"}
    assert distributed.worker_env_auto() == {"LUMI_DISTRIBUTED_AUTO": "1"}
    assert not distributed.requested({})
    assert distributed.requested({"LUMI_COORDINATOR": "h:1"})
    assert distributed.requested({"LUMI_DISTRIBUTED_AUTO": "1"})
    assert not distributed.initialize_from_env({})
    assert distributed.default_backend("cuda:0") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        distributed.initialize_from_env({
            "LUMI_DISTRIBUTED_AUTO": "1", "RANK": "0", "WORLD_SIZE": "1",
            "MASTER_ADDR": "127.0.0.1"})


def test_run_joins_a_coordinator_group(records, monkeypatch):
    """``train.run`` under ``LUMI_COORDINATOR`` (a one-process group here)
    trains, as the chief, and leaves no group behind."""
    import torch.distributed as dist

    monkeypatch.setenv("LUMI_COORDINATOR",
                       f"127.0.0.1:{distributed.free_port()}")
    monkeypatch.setenv("LUMI_NUM_PROCESSES", "1")
    monkeypatch.setenv("LUMI_PROCESS_ID", "0")
    state = trainer.run(_run_config(records, run_name="env", no_log=True),
                        max_steps=1, device="cpu")
    assert state.step == 1 and np.isfinite(state.history[0]["total_loss"])
    assert not dist.is_initialized()


def _eval_config(records):
    config = _run_config(records)
    port_eval.apply_eval_config_mutations(config, "train")
    return config


def test_eval_over_two_devices_is_bitwise(records):
    """Each replica runs its rows as one device runs them: the gathered
    detections and the losses of the merged predictions are bitwise
    those of one device's forwards of the same rows, so the AP over the
    dataset is one device's at a batch of one image. Against one device
    on the whole batch of two, the CPU's convolutions differ (they are
    not batch-size invariant: 4.2e-4 at most on this model's block3
    map), so the losses there agree to 1e-4 relative."""
    config = _eval_config(records)
    variables = init_variables(config, seed=0)
    model = load_flax_variables(FasterRCNN(config), variables).eval()
    image = torch.from_numpy(
        (np.random.RandomState(1).rand(2, 96, 128, 3) * 255).astype(
            np.float32))
    gt = torch.from_numpy(train_batch()["gt_boxes"])
    shape = torch.tensor([[96.0, 128.0], [80.0, 100.0]])
    replicas = replicate(model, ["cpu", "cpu"])
    assert replicas[0] is model and replicas[1] is not model
    with torch.inference_mode():
        two = port_eval.replicated_forward(replicas)(model, image, gt, shape)
        rows = []
        for i in range(2):
            with batch_shard(i, 2):
                rows.append(model(image[i:i + 1], gt_boxes=gt[i:i + 1],
                                  im_shape=shape[i:i + 1]))
        merged = concat_rows(rows, "cpu")
        cp = merged["classification_prediction"]
        want = (cp["objects"], cp["labels"], cp["probs"], cp["valid"],
                model.loss(merged, return_all=True))
        whole = port_eval.eval_forward(model, image, gt, shape)
    for got, expected in zip(two[:4], want[:4]):
        assert torch.equal(got, expected)
    assert set(two[4]) == set(want[4]) == set(whole[4])
    for key in want[4]:
        assert torch.equal(two[4][key], want[4][key]), key
        np.testing.assert_allclose(float(two[4][key]), float(whole[4][key]),
                                   rtol=1e-4, err_msg=key)

    metrics = port_eval.evaluate_once(config, model, devices=["cpu", "cpu"])
    config.train.batch_size = 1
    single = port_eval.evaluate_once(config, model)
    assert metrics["images"] == single["images"] == 4
    for key in ("AP@0.5", "AP@0.75", "AP@[0.5:0.95]", "AR@[0.5:0.95]"):
        assert metrics[key] == single[key], key


def test_predictor_over_two_devices_is_bitwise(records):
    """Four images over two replicas against one device predicting the
    same two pairs; three images round up to four."""
    config = _run_config(records)
    variables = init_variables(config, seed=0)
    rng = np.random.RandomState(2)
    images = [(rng.rand(80, 100, 3) * 255).astype(np.uint8)
              for _ in range(4)]
    one = PredictorNetwork(config, variables=variables, device="cpu")
    two = PredictorNetwork(config, variables=variables,
                           devices=["cpu", "cpu"])
    assert len(two._replicas) == 2 and len(one._replicas) == 1
    want = one.predict_batch(images[:2]) + one.predict_batch(images[2:])
    assert two.predict_batch(images) == want
    assert two.predict_batch(images[:3]) == want[:3]
