"""utils/profiling timing-sync regression.

`time_fn` must wait for execution (`jax.block_until_ready`), not just
dispatch. The observable contract testable on any backend: a timed call
whose execution provably takes T seconds (host callback sleep) must report
>= T.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np

from project3_cuda_path_tracer_tpu.utils import profiling


def test_time_fn_waits_for_execution():
    sleep_s = 0.05

    def slow(x):
        def cb(a):
            time.sleep(sleep_s)
            return np.asarray(a)
        return jax.pure_callback(
            cb, jax.ShapeDtypeStruct(x.shape, x.dtype), x)

    f = jax.jit(slow)
    dt = profiling.time_fn(f, jnp.ones((4,), jnp.float32),
                           iters=2, warmup=1)
    # Async dispatch returns immediately; only a real sync sees the sleep.
    assert dt >= sleep_s * 0.8, (
        "time_fn reported %.4fs for a %.2fs program: sync did not wait "
        "for execution" % (dt, sleep_s))


def test_sync_handles_pytrees_and_non_arrays():
    for out in ({"a": jnp.ones((2, 2)), "b": 3}, ("no", "arrays", 1),
                jnp.zeros(())):
        dt = profiling.time_fn(lambda: out, iters=2, warmup=1)
        assert dt >= 0


def test_ab_compare_returns_all_variants():
    f = jax.jit(lambda x: x * 2.0)
    g = jax.jit(lambda x: x + 1.0)
    x = jnp.ones((8,))
    out = profiling.ab_compare(
        {"mul": lambda: f(x), "add": lambda: g(x)}, iters=2)
    assert set(out) == {"mul", "add"}
    assert all(v >= 0 for v in out.values())
