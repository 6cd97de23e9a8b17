"""The port's two-rank train step against the JAX package's 2-device mesh.

Two steps of the JAX ``make_train_step(model, tx, mesh)`` on a 2-device
data mesh (of the 8 CPU devices ``tests/conftest.py`` gives) against two
steps of the port's ``make_train_step`` in two spawned gloo ranks, one
image each, on the setting of ``tests/test_torch_train.py`` (Faster R-CNN
ResNet-50 v1, 3 classes, a 2 x 96 x 128 batch, fixed subsampling keys
whose uniforms the port gets; the ranks take their rows of them). Both
packages start from the port's random init with the heads rescaled.

With fixed batch-norm statistics, the tolerances of that module's step
test: losses and gradient norm to 1e-5 relative, parameters to atol 1e-6
+ rtol 1e-5. With ``train_batch_norm`` (statistics of the global batch in
both), those of ``tests/test_torch_train_knobs.py``, whose docstring says
why batch statistics cannot hold the step test's: losses and gradient
norm to 5e-3 relative, each head parameter's move to 1e-2, all moves
together to 0.2, and each running statistic's move to 1e-2. The
``train_batch_norm`` case is in ``tests/test_torch_parallel_mesh_bn.py``
(one module each, so that ``--dist loadfile`` runs them side by side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu.parallel.mesh import make_mesh, shard_batch
from luminoth_tpu.train import TrainState, make_train_step as jax_step
from luminoth_tpu.utils import training as jax_training
from luminoth_tpu_torch.parallel.distributed import spawn_ranks
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    init_variables,
    nest_variables,
    torch_state_from_flax,
)
from test_torch_isolation import few_threads, jax_cache_isolation  # noqa: F401
from test_torch_train import (
    LOSS_RTOL,
    PARAM_ATOL,
    PARAM_RTOL,
    KeyedFasterRCNN,
    port_priorities,
    rescaled_variables,
)
from test_torch_train_knobs import (
    ALL_MOVES_RTOL,
    HEAD_MOVE_RTOL,
    KNOBS_LOSS_RTOL,
    STATS_MOVE_RTOL,
)
from torch_parallel_worker import (
    RANK_TIMEOUT_S,
    rank_steps,
    step_config,
    train_batch,
)

FLAGS = (False,)  # tests/test_torch_parallel_mesh_bn.py: True


def mesh_setting(flags):
    """The configs of ``flags``, the global batch and the variables."""
    batch = train_batch()
    configs = {flag: step_config(flag) for flag in flags}
    plain = step_config(False)
    variables = rescaled_variables(plain, batch, init=nest_variables(
        flatten_variables(init_variables(plain, seed=0))))
    return configs, batch, variables


def spawn_port_ranks(setting):
    """Two steps of each setting's config in one pair of spawned ranks;
    the chief's results by flag."""
    configs, batch, variables = setting
    ranks = spawn_ranks(
        rank_steps, ["cpu", "cpu"], threads=1,
        args=([(config, variables, batch) for config in configs.values()],
              port_priorities(2, 576, 32)), timeout=RANK_TIMEOUT_S)
    return dict(zip(configs, ranks[0]))


@pytest.fixture(scope="module")
def setting():
    return mesh_setting(FLAGS)


@pytest.fixture(scope="module")
def port_ranks(setting):
    return spawn_port_ranks(setting)


def jax_mesh_steps(config, batch, variables, train_batch_norm):
    """Two JAX steps on a 2-device data mesh: metrics, params and batch
    statistics after each."""
    params = variables["params"]
    mask = jax_training.build_trainable_mask(params, config.model)
    coeffs = jax_training.build_weight_decay_coefficients(params,
                                                          config.model)
    tx, _ = jax_training.get_optimizer(
        config.train, trainable_mask=mask, weight_decay=coeffs,
        weight_decay_mask=jax_training.build_weight_decay_mask(params))
    mesh = make_mesh(num_devices=2)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=tx.init(params),
                       batch_stats=variables["batch_stats"])
    step = jax_step(KeyedFasterRCNN(config), tx, mesh,
                    train_batch_norm=train_batch_norm, trainable_mask=mask,
                    reg_fn=lambda p: jax_training.l2_regularization_loss(
                        p, coeffs))
    device_batch = shard_batch(batch, mesh)
    out = []
    for _ in range(2):
        state, metrics = step(state, device_batch, jax.random.PRNGKey(9))
        out.append(({k: float(v) for k, v in metrics.items()},
                    torch_state_from_flax(jax.tree_util.tree_map(
                        np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats}))))
    return out


def _relative(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("train_batch_norm", FLAGS)
def test_two_ranks_match_the_jax_mesh(setting, port_ranks, train_batch_norm):
    check_against_the_jax_mesh(setting, port_ranks, train_batch_norm)


def check_against_the_jax_mesh(setting, port_ranks, train_batch_norm):
    """The chief's two steps against the JAX mesh's, at the tolerances of
    the module docstring."""
    configs, batch, variables = setting
    config = configs[train_batch_norm]
    want = jax_mesh_steps(config, batch, variables, train_batch_norm)
    got = port_ranks[train_batch_norm]
    # The chief's counts are its share of the global ones.
    assert all(local < total for local, total in got["counts"][0])
    loss_rtol = KNOBS_LOSS_RTOL if train_batch_norm else LOSS_RTOL
    for metrics, (want_metrics, _) in zip(got["metrics"], want):
        assert set(metrics) == set(want_metrics)
        for key, value in want_metrics.items():
            np.testing.assert_allclose(metrics[key], value, rtol=loss_rtol,
                                       err_msg=key)
    state, want_state = got["state"], want[-1][1]
    if not train_batch_norm:
        for key, value in want_state.items():
            np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=key)
        return
    start = torch_state_from_flax(variables)
    moves = {k: (state[k] - start[k], want_state[k] - start[k])
             for k in want_state if not torch.equal(want_state[k], start[k])}
    stats = [k for k in moves if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        assert _relative(*moves[key]) <= STATS_MOVE_RTOL, key
    params = {k: m for k, m in moves.items() if k not in stats}
    for key, (port, jax_move) in params.items():
        if key.startswith(("rpn.", "rcnn.")):
            assert _relative(port, jax_move) <= HEAD_MOVE_RTOL, key
    assert _relative(torch.cat([m.flatten() for m, _ in params.values()]),
                     torch.cat([m.flatten() for _, m in params.values()])
                     ) <= ALL_MOVES_RTOL
