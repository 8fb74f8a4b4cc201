"""The meta route of the kernel wrappers.

A wrapper (decorated with ``route``) given a tensor on the ``meta`` device
as its first argument (the dry-run's stand-ins, ``launch/input_specs.py``)
launches nothing: it runs its kernel's plain
version for the output shapes and dtypes only, inside
``kernel_region(name)``, and counts nothing in its ``launches``.
``launch/step_analysis.py`` listens to the regions (and counts them): what
a region's plain version computes the kernel keeps on chip, so its
intermediates count as the kernel's, and only what the region returns as
memory the kernel writes. This is the counterpart of the reference's
``flash_tile`` / ``ssd_tile`` / ``mlstm_tile`` scopes.

A plain version that needs the data (``.item()``, an index computed from
values) cannot run on meta tensors; ``run_plain`` raises then, naming the
kernel.
"""
from __future__ import annotations

import functools
from contextlib import contextmanager

#: Objects with ``region_enter(name)`` and ``region_exit(name)``, told of
#: every kernel region (step_analysis registers itself while it runs).
listeners: list = []


def on_kernel_route(t) -> bool:
    """A tensor an ``ops`` entry hands to the kernel wrapper: on the card
    (the kernel launches) or on ``meta`` (the meta route)."""
    return t.is_cuda or t.is_meta


@contextmanager
def kernel_region(name: str):
    for obj in list(listeners):
        obj.region_enter(name)
    try:
        yield
    finally:
        for obj in list(listeners):
            obj.region_exit(name)


def run_plain(name: str, plain, *args, **kwargs):
    """The meta route of the wrapper ``name``: ``plain(*args, **kwargs)``
    inside ``kernel_region(name)``."""
    try:
        with kernel_region(name):
            return plain(*args, **kwargs)
    except (RuntimeError, NotImplementedError) as e:
        if "meta" not in str(e):
            raise
        raise RuntimeError(f"{name}: its plain version cannot run on meta "
                           f"tensors ({e})") from e


def route(plain, ignore: tuple = ()):
    """The meta route of the decorated wrapper: a call whose first argument
    is a meta tensor runs ``plain`` on the wrapper's own arguments through
    ``run_plain`` under the wrapper's name, less the keyword options in
    ``ignore`` (which choose how the kernel launches, not what it
    computes); any other call runs the wrapper."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if args[0].is_meta:
                kw = {k: v for k, v in kwargs.items() if k not in ignore}
                return run_plain(fn.__name__, plain, *args, **kw)
            return fn(*args, **kwargs)
        return wrapper
    return wrap
