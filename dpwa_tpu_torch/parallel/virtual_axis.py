"""Named virtual axes: the port's stand-in for a mesh axis bound by
``shard_map``.

The reference's sequence-parallel model names its axis (``sp_axis="sp"``)
and learns its size from the mesh that ``shard_map`` binds around the call.
On one card the axis is virtual; :func:`bind` gives a name its size for the
duration of a call, and :func:`axis_size` reads it, raising for a name
nothing bound, as JAX does for an unbound axis name.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Mapping

_SIZES: contextvars.ContextVar[Mapping[str, int]] = contextvars.ContextVar(
    "virtual_axes", default={}
)


@contextlib.contextmanager
def bind(name: str, size: int) -> Iterator[None]:
    """Bind axis ``name`` to ``size`` ranks inside the ``with`` block."""
    if size < 1:
        raise ValueError(f"axis {name!r} needs a size >= 1, got {size}")
    token = _SIZES.set({**_SIZES.get(), name: int(size)})
    try:
        yield
    finally:
        _SIZES.reset(token)


def axis_size(name: str) -> int:
    """The size bound to axis ``name``."""
    sizes = _SIZES.get()
    if name not in sizes:
        raise NameError(f"unbound axis name: {name} (bind it with virtual_axis.bind)")
    return sizes[name]
