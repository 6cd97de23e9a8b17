"""Keep the port's tests out of the JAX package's shared compile caches.

The port's tests run JAX predictors, JAX ``evaluate_once`` and the JAX
``predict`` command as references. Left alone, those write to the caches
the JAX package shares across processes through its home directory: the
serialized executables of ``utils/aot_cache.py`` (pruned to the newest 16)
and XLA's persistent compilation cache, which ``PredictorNetwork`` turns
on. With several test processes on one home, the extra entries evict JAX
tests' executables; a JAX test then stores an executable that XLA served
from the compilation cache entry of another process, and the process that
loads it fails with ``NOT_FOUND: Buffer Definition Event: Function ... not
found``.

:func:`isolated_jax_caches` turns both caches off for its span: it sets
``LUMI_NO_AOT_CACHE`` (no executable is stored, loaded or evicted) and
``LUMI_NO_COMPILATION_CACHE`` (``enable_persistent_cache`` sets nothing),
and holds ``jax_persistent_cache_min_compile_time_secs`` at 1e9, which
stops writes to a cache directory that an earlier JAX test of the same
process already set (JAX decides once per process whether the cache is
used, so turning ``jax_enable_compilation_cache`` off later does not stop
them; the threshold is read at each write). The previous threshold comes
back afterwards. Every port test module that reaches a JAX predictor,
evaluator or the JAX ``predict`` command imports :func:`jax_cache_isolation`,
a module-scoped autouse fixture, so the module's JAX references compute
through plain ``jax.jit``.
"""

import contextlib
import os
import subprocess
import sys
import textwrap

import jax
import pytest

THRESHOLD = "jax_persistent_cache_min_compile_time_secs"
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


@contextlib.contextmanager
def isolated_jax_caches():
    """Both JAX caches off, and the compile-time threshold at 1e9, for the
    span of the context; the previous threshold is restored after."""
    previous = getattr(jax.config, THRESHOLD)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("LUMI_NO_AOT_CACHE", "1")
        patch.setenv("LUMI_NO_COMPILATION_CACHE", "1")
        jax.config.update(THRESHOLD, 1e9)
        try:
            yield
        finally:
            jax.config.update(THRESHOLD, previous)


@pytest.fixture(scope="module", autouse=True)
def jax_cache_isolation():
    with isolated_jax_caches():
        yield


PROBE = textwrap.dedent("""
    import json, os, sys
    home = sys.argv[1]
    os.environ["LUMI_HOME"] = home
    sys.path[:0] = [{repo!r}, {tests!r}]
    import jax, jax.numpy as jnp, numpy as np
    from luminoth_tpu.utils.compilation_cache import enable_persistent_cache
    from luminoth_tpu.utils.predicting import PredictorNetwork
    from luminoth_tpu_torch.utils.weights import init_variables
    from test_torch_isolation import THRESHOLD, isolated_jax_caches
    from test_torch_ssd import jax_variables, small_config

    def files():
        return sorted(os.path.relpath(os.path.join(d, n), home)
                      for d, _, names in os.walk(home) for n in names)

    # As an earlier JAX test of the process would: the cache on, and a
    # compile written to it (a threshold of 0 admits this small one).
    cache_dir = enable_persistent_cache()
    jax.config.update(THRESHOLD, 0.0)
    jax.jit(lambda x: jnp.sin(x) * 2.0)(jnp.ones(3)).block_until_ready()
    control = files()
    before = getattr(jax.config, THRESHOLD)
    config = small_config()
    with isolated_jax_caches():
        predictor = PredictorNetwork(
            config, variables=jax_variables(config, init_variables(config)),
            mesh=None)
        predictor.predict_batch(
            [np.zeros((40, 60, 3), np.uint8)])
    print(json.dumps({{
        "cache_dir": os.path.relpath(cache_dir, home),
        "control": control, "after": files(), "before": before,
        "restored": getattr(jax.config, THRESHOLD)}}))
""").format(repo=REPO, tests=TESTS)


def test_a_jax_predictor_under_the_isolation_writes_no_cache_entry(
        tmp_path):
    """One JAX ``PredictorNetwork(mesh=None)`` build and forward in a
    fresh process whose compilation cache is on and in use (the control
    compile wrote an entry under ``LUMI_HOME``): under the isolation no
    ``.aot`` file and no compilation-cache entry appear, and the threshold
    in force before is restored after."""
    import json

    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items()
             if k not in ("LUMI_NO_AOT_CACHE", "LUMI_NO_COMPILATION_CACHE")},
    )
    assert out.returncode == 0, out.stderr[-4000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["cache_dir"] == "compilation_cache"
    assert any(f.startswith("compilation_cache/") for f in report["control"])
    assert report["after"] == report["control"]
    assert not any(f.endswith(".aot") for f in report["after"])
    assert report["restored"] == report["before"] == 0.0


def test_the_fixture_holds_the_threshold_and_the_switches():
    assert getattr(jax.config, THRESHOLD) == 1e9
    assert os.environ["LUMI_NO_AOT_CACHE"] == "1"
    assert os.environ["LUMI_NO_COMPILATION_CACHE"] == "1"


@pytest.fixture(scope="module", autouse=True)
def lumi_home_isolation(tmp_path_factory):
    """A temporary ``LUMI_HOME`` for the module; yields its path.

    ``train.run`` with logging on appends a line (with the working tree's
    ``git diff``) to the run journal, ``runs.json`` in the home the port
    shares with the JAX package. Every port test module that runs it
    imports this fixture, so that no test writes the user's home; the
    subprocesses those modules start inherit the variable.
    """
    home = tmp_path_factory.mktemp("lumi_home")
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("LUMI_HOME", str(home))
        yield str(home)
