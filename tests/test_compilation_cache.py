"""The per-process JAX persistent compilation cache that the repo's root
conftest.py gives every test process: where it lives, that JAX uses it, and
that what it loads initialises the same weights as what was compiled."""
import os
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
from jax._src import compilation_cache

from pww_tpu.config import SDModelConfig
from pww_tpu.models.clip import CLIPTextEncoder

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_cache_dir_is_this_process_own_and_in_use():
    path = jax.config.jax_compilation_cache_dir
    assert path and os.path.isdir(path)
    resolved = pathlib.Path(path).resolve()
    assert REPO not in resolved.parents
    assert pathlib.Path(tempfile.gettempdir()).resolve() in resolved.parents
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    assert os.path.basename(path).startswith(f"pww-jax-cache-{worker}-")
    # A program never compiled before is written to this directory. JAX
    # settles the cache's directory at the process's first compile, so the
    # cache being at this path shows the conftest set it before that.
    before = len(os.listdir(path))
    jax.jit(lambda x: x * 3.0 + 7.0)(jnp.arange(5.0)).block_until_ready()
    assert len(os.listdir(path)) > before
    assert pathlib.Path(compilation_cache._cache.path) == pathlib.Path(path)


def _init_counting_cache_use(module, ids):
    """``module``'s eager flax init, the number of programs it asked of the
    persistent cache, and how many of them the cache had."""
    events = []

    def listen(event, **_):
        events.append(event)

    jax.monitoring.register_event_listener(listen)
    try:
        params = module.init(jax.random.PRNGKey(0), ids)
    finally:
        jax.monitoring.unregister_event_listener(listen)
    return (params,
            events.count("/jax/compilation_cache/compile_requests_use_cache"),
            events.count("/jax/compilation_cache/cache_hits"))


def test_init_loaded_from_cache_equals_compiled():
    # The tiny pipeline's text encoder, initialised eagerly as
    # PwwPipeline.init_params does: its embeddings are the leaves that came
    # out different when the init was compiled as one program instead. The
    # whole tiny pipeline takes ~100 s to compile on an 8-core CPU; this ~10.
    cfg = SDModelConfig.tiny()
    clip = CLIPTextEncoder(cfg.clip, dtype=jnp.bfloat16)
    ids = jnp.zeros((1, cfg.clip.max_position_embeddings), jnp.int32)
    # An empty cache of its own, so that the first init compiles every
    # program whatever the worker ran before, and the second loads them all.
    worker_dir = jax.config.jax_compilation_cache_dir
    with tempfile.TemporaryDirectory(prefix="pww-jax-cache-test-") as path:
        jax.config.update("jax_compilation_cache_dir", path)
        compilation_cache.reset_cache()
        try:
            jax.clear_caches()
            first, requests, hits = _init_counting_cache_use(clip, ids)
            # Every program compiled by XLA and written to the cache.
            assert requests > 0 and hits == 0
            assert len(os.listdir(path)) == requests
            jax.clear_caches()
            second, requests, hits = _init_counting_cache_use(clip, ids)
            # Every program loaded from what the first init wrote.
            assert requests > 0 and hits == requests
        finally:
            jax.config.update("jax_compilation_cache_dir", worker_dir)
            compilation_cache.reset_cache()

    assert jax.tree.structure(first) == jax.tree.structure(second)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(first),
                            jax.tree.leaves(second)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
