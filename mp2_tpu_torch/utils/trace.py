"""Hierarchical tracing spans (the ryhope `tracing` role, SURVEY.md §5).

A copy of `mp2_tpu/utils/trace.py` (which imports no JAX either): the
recursion runtime opens its spans here.

The reference uses `log`/`env_logger` everywhere plus `tracing` spans in
ryhope; plonky2 exposes `timed!` scopes.  This module is the equivalent:
nested wall-clock spans with near-zero overhead when disabled.

  from mp2_tpu_torch.utils.trace import span, tracing_enabled

  with span("prove", circuit="rows_leaf"):
      with span("witness"):
          ...

Enable with MP2_TRACE=1 (stderr lines, indented by depth) and/or
MP2_TRACE_JSON=path (one JSON object per span, chrome://tracing-style
fields: name, ts_us, dur_us, depth, attrs).  `report()` aggregates
(count, total seconds) per span name for in-process inspection.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, Tuple

_state = threading.local()


def _enabled() -> bool:
    return bool(
        os.environ.get("MP2_TRACE") or os.environ.get("MP2_TRACE_JSON")
    )


def tracing_enabled() -> bool:
    return _enabled()


_totals: Dict[str, Tuple[int, float]] = {}
_totals_lock = threading.Lock()


@contextmanager
def span(name: str, **attrs):
    """A timed scope; no-op (single `if`) when tracing is off."""
    if not _enabled():
        yield
        return
    depth = getattr(_state, "depth", 0)
    _state.depth = depth + 1
    t0 = time.perf_counter()
    ts_us = int(time.time() * 1e6)
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _state.depth = depth
        with _totals_lock:
            n, tot = _totals.get(name, (0, 0.0))
            _totals[name] = (n + 1, tot + dt)
        if os.environ.get("MP2_TRACE"):
            extra = "".join(f" {k}={v}" for k, v in attrs.items())
            print(
                f"[trace] {'  ' * depth}{name}{extra} {dt * 1e3:.1f}ms",
                file=sys.stderr,
            )
        path = os.environ.get("MP2_TRACE_JSON")
        if path:
            rec = {
                "name": name, "ts_us": ts_us, "dur_us": int(dt * 1e6),
                "depth": depth, "attrs": attrs,
            }
            with _totals_lock:
                with open(path, "a") as f:
                    f.write(json.dumps(rec) + "\n")


def report() -> Dict[str, Tuple[int, float]]:
    """{span name: (count, total seconds)} accumulated so far."""
    with _totals_lock:
        return dict(_totals)


def reset() -> None:
    with _totals_lock:
        _totals.clear()
