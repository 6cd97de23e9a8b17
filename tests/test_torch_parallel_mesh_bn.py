"""``tests/test_torch_parallel_mesh.py``'s two-rank steps with
``train_batch_norm`` (statistics of the global batch in both packages)
against the JAX package's 2-device mesh, at that module's tolerances for
batch statistics (its docstring says which and why).
"""

import pytest

from test_torch_isolation import few_threads, jax_cache_isolation  # noqa: F401
from test_torch_parallel_mesh import (
    check_against_the_jax_mesh,
    mesh_setting,
    spawn_port_ranks,
)

FLAGS = (True,)


@pytest.fixture(scope="module")
def setting():
    return mesh_setting(FLAGS)


@pytest.fixture(scope="module")
def port_ranks(setting):
    return spawn_port_ranks(setting)


@pytest.mark.parametrize("train_batch_norm", FLAGS)
def test_two_ranks_match_the_jax_mesh(setting, port_ranks, train_batch_norm):
    check_against_the_jax_mesh(setting, port_ranks, train_batch_norm)
