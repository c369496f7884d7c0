"""Device-dispatch accounting.

Why: a host-facing match path's wall time includes (dispatch count) x
(per-dispatch latency). These counters separate "the device or host was
slow" from "the code grew a dispatch", and make the count
regression-testable.

Two tiers:

* **Execution counts** — `counted_jit(fn, name)` wraps OUR jitted entry
  callables (detector pyramid/match/pack programs). Always on; the cost
  is one Counter increment per call. JAX's C++ pjit fast path bypasses
  every Python-level hook on warm calls (verified on jax 0.9), so
  wrapping our own callables is the only reliable execution count.
* **Transfer counts** — `instrument_transfers()` monkeypatches
  `pxla.batched_device_put` (H2D: the live Python chokepoint for
  jnp.asarray(np_array) / jax.device_put on jax 0.9 — verified warm
  calls hit it) and the Python-attached `ArrayImpl.__array__` (D2H:
  fires on accelerators where np.asarray must really pull; on the CPU
  backend numpy reads the buffer zero-copy and bypasses it, so hot
  paths ALSO mark their pulls explicitly via `count("d2h_pulls")` —
  those are what the CPU regression test pins). Opt-in (bench, tests,
  `sbm info`): patching jax internals stays out of library import.

Not counted: eager jnp ops on device arrays (apply_primitive is
cpp-cached warm) and scalar-constant creation (weak-type constants
cache below batched_device_put) — the library's match paths are
dispatch-audited to not issue any; the pinned regression test
(tests/test_dispatch_count.py) is what keeps it that way.
"""

from __future__ import annotations

import contextlib
import functools
from collections import Counter

COUNTS: Counter = Counter()

_TRANSFERS_INSTALLED = False


def counted_jit(fn, name: str):
    """Wrap a jitted callable: count executions under `exec:{name}`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        COUNTS["exec_total"] += 1
        COUNTS[f"exec:{name}"] += 1
        return fn(*args, **kwargs)

    wrapper.__wrapped__ = fn
    return wrapper


def count(key: str, n: int = 1) -> None:
    """Manual increment for named host<->device boundaries."""
    COUNTS[key] += n


def instrument_transfers() -> None:
    """Install H2D/D2H transfer counting (idempotent)."""
    global _TRANSFERS_INSTALLED
    if _TRANSFERS_INSTALLED:
        return
    import jax
    import jax._src.interpreters.pxla as _px

    orig_put = _px.batched_device_put

    @functools.wraps(orig_put)
    def _put(*args, **kwargs):
        COUNTS["h2d_total"] += 1
        return orig_put(*args, **kwargs)

    _px.batched_device_put = _put

    # the concrete runtime array type (jaxlib._jax.ArrayImpl on 0.9);
    # __array__ is a Python method attached to it, so setattr works.
    arr_t = type(jax.numpy.zeros(()))
    orig_array = arr_t.__array__

    @functools.wraps(orig_array)
    def _array(self, *args, **kwargs):
        COUNTS["d2h_total"] += 1
        return orig_array(self, *args, **kwargs)

    try:
        arr_t.__array__ = _array
    except TypeError:  # future jaxlib making it a C slot: skip d2h
        pass
    _TRANSFERS_INSTALLED = True


def snapshot() -> dict:
    return dict(COUNTS)


def reset() -> None:
    COUNTS.clear()


@contextlib.contextmanager
def measure(transfers: bool = False):
    """Yield a dict that, after the block, holds the dispatch-count
    DELTA incurred inside it. `transfers=True` also installs (and
    leaves installed) the H2D/D2H patches."""
    if transfers:
        instrument_transfers()
    before = snapshot()
    delta: dict = {}
    try:
        yield delta
    finally:
        after = snapshot()
        for k, v in after.items():
            d = v - before.get(k, 0)
            if d:
                delta[k] = d
