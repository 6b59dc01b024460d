"""Parity helpers for the port's audio decoders against the JAX package's.

Both packages run the same decoder code on the same numpy in these tests, so
parity is exact: the same arrays bit for bit (dtype and shape included), the
same rate and other returns, or the same exception class and message.
"""

from __future__ import annotations

import numpy as np
from hypothesis import HealthCheck, settings
from hypothesis import strategies as st

# bounded and reproducible: the same examples on every run, no example
# database written beside the tests
FUZZ = settings(max_examples=100, deadline=None, derandomize=True, database=None,
                suppress_health_check=list(HealthCheck))


def outcome(fn, *args, **kw):
    """("ok", result) or ("raise", class name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return ("raise", type(e).__name__, str(e))


def assert_same(jax_fn, port_fn, *args, **kw):
    """Call both decoders on the same input and hold the port's outcome to
    JAX's; returns the port's outcome."""
    want, got = outcome(jax_fn, *args, **kw), outcome(port_fn, *args, **kw)
    assert got[0] == want[0], (want if want[0] == "raise" else "ok",
                               got if got[0] == "raise" else "ok")
    if want[0] == "raise":
        assert got[1:] == want[1:]
        return got
    w, g = want[1], got[1]
    if not isinstance(w, tuple):
        w, g = (w,), (g,)
    assert len(g) == len(w)
    for a, b in zip(w, g):
        if isinstance(a, np.ndarray):
            assert (b.dtype, b.shape) == (a.dtype, a.shape)
            np.testing.assert_array_equal(b, a)
        else:
            assert type(b) is type(a) and b == a
    return got


@st.composite
def mutations(draw, size: int, max_flips: int = 4):
    """[(position, xor mask)] byte flips inside `size` bytes, and a length to
    truncate to (None: none)."""
    flips = draw(st.lists(st.tuples(st.integers(0, size - 1), st.integers(1, 255)),
                          min_size=1, max_size=max_flips))
    cut = draw(st.one_of(st.none(), st.integers(1, size)))
    return flips, cut


def mutate(data: bytes, flips, cut) -> bytes:
    buf = bytearray(data)
    for pos, mask in flips:
        buf[pos] ^= mask
    return bytes(buf[:cut] if cut is not None else buf)
