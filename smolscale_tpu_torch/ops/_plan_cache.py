"""The ops layer's per-plan caches, and a scope that forgets what it added.

Each kernel keeps what it derives from a plan (index tables on a device,
launch-shape sums, a gate) for the life of the process, as
``functools.cache`` would.  A caller that sweeps many plans once each, as
``cli check`` does, opens :func:`transient` around each one: the entries
made inside the scope are dropped when it closes, and entries that were
there before it opened stay, so other callers in the process keep theirs.
"""

from __future__ import annotations

import contextlib
import functools

# the entries added while each open scope was open, innermost last
_scopes: list[list] = []


def plan_cache(fn):
    """``functools.cache`` for a function of positional, hashable arguments
    (a plan first), whose entries a :func:`transient` scope can forget."""
    table: dict = {}

    @functools.wraps(fn)
    def cached(*args):
        try:
            return table[args]
        except KeyError:
            pass
        value = table[args] = fn(*args)
        for added in _scopes:
            added.append((table, args))
        return value

    cached.cache_len = table.__len__
    return cached


@contextlib.contextmanager
def transient():
    """Forget, on exit, every per-plan entry made inside the scope."""
    added: list = []
    _scopes.append(added)
    try:
        yield
    finally:
        # by identity: an inner scope's list may equal this one
        del _scopes[next(k for k, s in enumerate(_scopes) if s is added)]
        for table, key in added:
            table.pop(key, None)
