"""The port's host counters, in one registry.

Kernel wrappers, landing copies and route-before-gather layers count on
the host as they run: kernel launches, the path of each launch, bytes
landed from peers, demand layers. A captured CUDA graph replays without
the host, so a captured step records what its capture counted
(:func:`recording`) and adds that record at each replay (:func:`add`).
Every counter registers here where it is defined, so a record covers all
of them and the caller names none.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Iterator

_COUNTERS: dict[str, tuple[object, tuple[str, ...]]] = {}


def register(name: str, counter, fields: tuple[str, ...] = ()) -> None:
    """Register ``counter`` under ``name``: a ``collections.Counter``
    (each key counts), or an object whose integer attributes ``fields``
    count."""
    _COUNTERS[name] = (counter, tuple(fields))


def snapshot() -> collections.Counter:
    """Every registered count, keyed ``(name, key or field)``."""
    out = collections.Counter()
    for name, (counter, fields) in _COUNTERS.items():
        if fields:
            for f in fields:
                out[(name, f)] = getattr(counter, f)
        else:
            for key, n in counter.items():
                out[(name, key)] = n
    return out


def add(delta) -> None:
    """Add ``delta`` (keyed as :func:`snapshot`) to the counters."""
    for (name, key), n in delta.items():
        counter, fields = _COUNTERS[name]
        if fields:
            setattr(counter, key, getattr(counter, key) + n)
        else:
            counter[key] += n
            if not counter[key]:
                del counter[key]


@contextlib.contextmanager
def recording() -> Iterator[collections.Counter]:
    """Record what the counters count inside the context and take it back
    out of them on exit: the yielded record holds the nonzero differences
    once the context has closed, and the counters read as before it."""
    record = collections.Counter()
    before = snapshot()
    try:
        yield record
    finally:
        after = snapshot()
        for key in before.keys() | after.keys():
            if after[key] != before[key]:
                record[key] = after[key] - before[key]
        add({key: -n for key, n in record.items()})
