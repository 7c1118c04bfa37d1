"""Small helpers shared across the port."""

import contextlib
import gc


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic garbage collector paused while circuits are defined
    and compiled: a circuit's millions of small cells and closures hold no
    cycles, yet each collection walks them all again.  Speed only; the
    collector's earlier state is restored on exit.  Also a decorator."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
