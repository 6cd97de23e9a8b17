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

Every port test module also imports :func:`few_threads`, which holds torch
to two intra-op threads in the module's process and in the processes it
starts (``OMP_NUM_THREADS``): under ``-n 6`` six workers share the
machine's cores, and a full thread pool per worker spins against the
others. On an 8-core CPU one ``train.run`` step of Faster R-CNN R50 at
2 x 96 x 128 took ~62 s in each of six such processes at once, and ~7 s
with two threads each.

Both cache fixtures also give the module's memory back when the module ends
(:func:`release_memory`): an xdist worker runs many modules in one
process, and the heap their JAX references and models freed stayed
resident, so the six workers of a full ``-n 6`` run held ~36 GB between
them at its end (8 GB the largest). A machine that ends large processes
under memory pressure then interrupts the last tests running on several
workers at once.
"""

import contextlib
import ctypes
import gc
import os
import re
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

THRESHOLD = "jax_persistent_cache_min_compile_time_secs"
THREADS = 2
DEFAULT_THREADS = torch.get_num_threads()  # torch's own count, at import
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def release_memory():
    """Drop JAX's compiled executables and tracing caches, collect, and
    return the freed heap to the system (glibc's ``malloc_trim``: freed
    chunks between live ones otherwise stay in the process's RSS)."""
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc: nothing to trim
        pass


@contextlib.contextmanager
def isolated_jax_caches():
    """Both JAX caches off, and the compile-time threshold at 1e9, for the
    span of the context; the previous threshold is restored after, and the
    span's memory released (:func:`release_memory`)."""
    previous = getattr(jax.config, THRESHOLD)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("LUMI_NO_AOT_CACHE", "1")
        patch.setenv("LUMI_NO_COMPILATION_CACHE", "1")
        jax.config.update(THRESHOLD, 1e9)
        try:
            yield
        finally:
            jax.config.update(THRESHOLD, previous)
            release_memory()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """``THREADS`` intra-op threads for the module, here and (through
    ``OMP_NUM_THREADS``) in the ranks and commands it starts; the previous
    count comes back after."""
    previous = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("OMP_NUM_THREADS", str(THREADS))
        yield
    torch.set_num_threads(previous)


@pytest.fixture
def default_threads():
    """Torch's own thread count for one test whose float32 sums hold
    their bound only in the order that count gives."""
    previous = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(previous)


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
    release_memory()


RELEASE_PROBE = textwrap.dedent("""
    import json, sys
    sys.path[:0] = [{repo!r}, {tests!r}]
    import jax, jax.numpy as jnp, numpy as np

    def rss_mb():
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) / 1e3 for line in f
                        if line.startswith("VmRSS"))

    from test_torch_isolation import isolated_jax_caches
    base = rss_mb()
    with isolated_jax_caches():
        double = jax.jit(lambda x: x * 2)
        double(jnp.ones(3)).block_until_ready()
        # 1 GB in 256 KB blocks with a small live array after each, as a
        # module's freed tensors sit between the arrays that outlive it.
        blocks, pins = [], []
        for _ in range(4000):
            blocks.append(np.ones(256 * 1024 // 8))
            pins.append(np.ones(1000))
        del blocks
        cached = double._cache_size()
        held = rss_mb()
    print(json.dumps({{"base": base, "held": held, "after": rss_mb(),
                      "cached": cached, "left": double._cache_size()}}))
""").format(repo=REPO, tests=TESTS)


def test_the_isolation_gives_the_memory_back(tmp_path):
    """After the context (and so after each module that uses a fixture of
    this file) the freed heap is no longer resident and JAX holds no
    compiled executable of it."""
    import json

    out = subprocess.run([sys.executable, "-c", RELEASE_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["held"] - report["base"] > 900
    assert report["after"] - report["base"] < 200
    assert report["cached"] == 1 and report["left"] == 0


# What a port test module calls, and the isolation it must import for it.
ISOLATION_NEEDS = {
    "lumi_home_isolation": (r"\btrainer\.run\(", r"\bjax_train\.run\("),
    "jax_cache_isolation": (
        r"\bjax_train\.run\(", r"\bjax_eval\.evaluate_once\(",
        r"\bJax\w*PredictorNetwork\(", r"\bjax_predict\b",
    ),
}


def test_port_test_modules_import_the_isolation_they_need():
    """Every ``tests/test_torch_*.py`` that runs the port's or the JAX
    package's ``train.run`` imports ``lumi_home_isolation``, and every one
    that runs the JAX ``train.run``, evaluator, predictor or ``predict``
    command imports ``jax_cache_isolation``."""
    import glob

    checked = set()
    for path in sorted(glob.glob(os.path.join(TESTS, "test_torch_*.py"))):
        with open(path) as f:
            source = f.read()
        imports = re.findall(
            r"from test_torch_isolation import (\([^)]*\)|[^\n]*)", source)
        imported = set(re.findall(r"\w+_isolation", " ".join(imports)))
        for fixture, calls in ISOLATION_NEEDS.items():
            if any(re.search(call, source) for call in calls):
                checked.add(os.path.basename(path))
                assert fixture in imported, (
                    f"{os.path.basename(path)} needs {fixture}")
    assert {"test_torch_train.py", "test_torch_train_knobs.py"} <= checked


def test_port_test_modules_hold_few_threads():
    """Every ``tests/test_torch_*.py`` that runs on the CPU imports
    ``few_threads`` (the card's kernel tests run alone); here it holds."""
    import glob

    for path in sorted(glob.glob(os.path.join(TESTS, "test_torch_*.py"))):
        name = os.path.basename(path)
        if name in ("test_torch_cuda.py", "test_torch_isolation.py"):
            continue
        with open(path) as f:
            imports = re.findall(
                r"from test_torch_isolation import (\([^)]*\)|[^\n]*)",
                f.read())
        assert "few_threads" in re.findall(r"\w+", " ".join(imports)), name
    assert torch.get_num_threads() == THREADS
    assert os.environ["OMP_NUM_THREADS"] == str(THREADS)


# The port's modules that read TF checkpoints and run data-parallel: the
# TF-free reader and converters must not reach for TensorFlow, and none
# may load the JAX package or JAX.
ISOLATED_MODULES = (
    "luminoth_tpu_torch.formats.tf_checkpoint",
    "luminoth_tpu_torch.tools.checkpoint.slim_convert",
    "luminoth_tpu_torch.tools.checkpoint.zoo_convert",
    "luminoth_tpu_torch.parallel",
    "luminoth_tpu_torch.parallel.distributed",
    "luminoth_tpu_torch.parallel.mesh",
)


@pytest.mark.parametrize("module", ISOLATED_MODULES)
def test_module_imports_neither_jax_nor_tensorflow(module):
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {REPO!r})
        importlib.import_module({module!r})
        print(sorted(n for n in sys.modules if n.split(".")[0] in (
            "luminoth_tpu", "jax", "jaxlib", "flax", "tensorflow")))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
