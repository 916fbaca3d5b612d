"""Settings for every test process, loaded by pytest before tests/conftest.py
(and so before its ``import jax``).

Each test process that loads JAX gets its own JAX persistent compilation
cache, in a fresh directory under the system temp directory that the process
removes when its session ends. Flax ``init`` runs eagerly in the reference's
``PwwPipeline.init_params`` and the adapter loaders, so one default-initialised
tiny pipeline compiles ~600 one-operation XLA programs (~100 s of an 8-core
CPU). tests/conftest.py's ``_bounded_compiler_state`` drops those executables
after every module; with the cache, the next module loads them from disk
(~16 s) instead of compiling them again. A directory is never shared between
live processes, so no read can see an entry that another process is still
writing, and never reused across runs or machines.

Loading a cached executable makes XLA:CPU log two false "machine type doesn't
match" errors per program (the entry was compiled by this very process), over
a thousand lines per pipeline build. ``TF_CPP_MIN_LOG_LEVEL=3`` silences them,
and with them every other XLA/TSL C++ log line below FATAL; Python warnings,
exceptions and tracebacks are untouched. The setting goes into the test
process's environment, so every subprocess a test starts (``chip_smoke.py``,
the notebooks, the multichip dry run) inherits it. Set
``TF_CPP_MIN_LOG_LEVEL`` in the environment to see the C++ logs again.
"""
import os
import shutil
import sys
import tempfile

# Read by the C++ logger when jaxlib loads, so it must precede `import jax`.
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")


def pytest_configure(config):
    # The conftests of the paths under test are loaded by now; a run whose
    # conftests load no JAX (portbench/tests) gets no cache.
    if "jax" not in sys.modules:
        return
    import jax

    # Runs before any test module is imported, so before the first compile:
    # JAX reads the directory once, when it first compiles.
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    config._pww_jax_cache_dir = tempfile.mkdtemp(prefix=f"pww-jax-cache-{worker}-")
    jax.config.update("jax_compilation_cache_dir", config._pww_jax_cache_dir)
    # Keep every program: each of the eager inits' one-op programs compiles
    # in well under JAX's default 1-s threshold, but there are hundreds.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def pytest_unconfigure(config):
    if hasattr(config, "_pww_jax_cache_dir"):
        shutil.rmtree(config._pww_jax_cache_dir, ignore_errors=True)
