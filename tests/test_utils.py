"""utils + multihost helpers + per-host batch sharding."""

import jax.numpy as jnp
import numpy as np
import pytest

from mgr_tpu.parallel import multihost
from mgr_tpu.utils import Timer, tree_count_params, tree_norm
from mgr_tpu.utils.trees import tree_equal


def test_tree_count_and_norm():
    tree = {"a": jnp.ones((2, 3)), "b": {"c": jnp.full((4,), 2.0)}}
    assert tree_count_params(tree) == 10
    np.testing.assert_allclose(
        float(tree_norm(tree)), np.sqrt(6 * 1 + 4 * 4), rtol=1e-6
    )


def test_tree_equal():
    a = {"x": jnp.arange(3)}
    b = {"x": jnp.arange(3)}
    c = {"x": jnp.arange(1, 4)}
    assert tree_equal(a, b)
    assert not tree_equal(a, c)
    assert not tree_equal(a, {"y": jnp.arange(3)})


def test_timer():
    with Timer() as t:
        sum(range(1000))
    assert t.seconds >= 0.0


def test_multihost_single_process_noop():
    multihost.initialize()  # no coordinator -> no-op
    assert multihost.is_primary()
    info = multihost.process_info()
    assert info["process_count"] == 1
    assert info["global_devices"] >= 1


def test_per_host_batch_sharding():
    from mgr_tpu.data.batcher import Batcher

    N = 16
    feats = np.arange(N * 4 * 2, dtype=np.float32).reshape(N, 4, 2)
    labels = np.zeros((N, 3), np.int32)
    ll = np.ones((N,), np.int32)
    il = np.full((N,), 4, np.int32)
    ids = list(range(N))
    b = Batcher(feats, labels, ll, il, ids, ids, [])

    shard0 = [c for c, _ in b.epoch(2, shuffle_seed=1, process_index=0,
                                    process_count=2)]
    shard1 = [c for c, _ in b.epoch(2, shuffle_seed=1, process_index=1,
                                    process_count=2)]
    full = [c for c, _ in b.epoch(2, shuffle_seed=1)]
    # Disjoint, interleaved, and jointly covering the full stream.
    assert shard0 + shard1 != full  # interleaved order differs
    assert sorted(map(tuple, shard0 + shard1)) == sorted(map(tuple, full))
    flat0 = {x for c in shard0 for x in c}
    flat1 = {x for c in shard1 for x in c}
    assert flat0.isdisjoint(flat1)


def test_tracing_helpers():
    import jax

    from mgr_tpu.core import tracing

    with tracing.annotate("test-region"):
        pass
    with tracing.trace(None):  # disabled: no logdir
        pass
    tracing.debug_nans(True)
    try:
        assert jax.config.jax_debug_nans
    finally:
        tracing.debug_nans(False)


def test_all_gather_and_reduce_scatter():
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from mgr_tpu.core.config import MeshConfig
    from mgr_tpu.parallel import collectives, make_mesh

    if len(jax.devices()) < 8:
        return
    mesh = make_mesh(MeshConfig(data=8, model=1))
    x = jnp.arange(8.0)

    g = shard_map(
        partial(collectives.all_gather, axis="data"),
        mesh=mesh, in_specs=P("data"), out_specs=P("data"),
    )
    out = np.asarray(g(x))  # each shard gathers the full vector
    assert out.shape == (64,)
    np.testing.assert_allclose(out[:8], np.arange(8.0))

    rs = shard_map(
        partial(collectives.reduce_scatter, axis="data"),
        mesh=mesh, in_specs=P("data"), out_specs=P("data"),
    )
    # Each shard holds one element; psum_scatter of the sharded vector
    # redistributes the summed shards.
    out2 = np.asarray(rs(jnp.ones(64)))
    assert out2.shape == (8,)
    np.testing.assert_allclose(out2, 8.0)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
    without it the cache sits at the fixed, git-ignored in-checkout
    path (never a temporary or per-process one)."""
    import os

    import jax

    from mgr_tpu.core import compile_cache

    before = jax.config.jax_compilation_cache_dir
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        if env_dir is None:
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
            got = compile_cache.enable_compile_cache()
            assert got == os.path.join(checkout, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            with open(os.path.join(checkout, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split()
        else:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv(compile_cache.ENV_VAR, want)
            assert compile_cache.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
