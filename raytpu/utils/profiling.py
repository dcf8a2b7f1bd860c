"""Tracing / profiling utilities.

The reference's whole observability story is one chrono wall-clock around
enqueue+finish printed as "Exec time" (main.cpp:352-374) plus a device-info
dump.  The JAX equivalents here:

  * Timer            — block_until_ready wall-clock sections with a
                       structured summary (feeds the bench JSON).
  * profile_trace    — context manager around jax.profiler.trace, producing
                       a perfetto/tensorboard trace directory.
  * scoped           — jax.named_scope wrapper so bounce levels/stages are
                       legible in XLA/Pallas profiles.
"""

from __future__ import annotations

import contextlib
import time

import jax


class Timer:
    """Accumulate named wall-clock sections; every section blocks on its
    value so device work is fully attributed."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            value = box.get("value", result)
            if value is not None:
                jax.block_until_ready(value)
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> dict:
        return dict(self.sections)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """jax.profiler trace (view with tensorboard/perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def scoped(name: str):
    """Decorator: wrap a function in jax.named_scope(name)."""

    def deco(fn):
        def wrapper(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)

        wrapper.__name__ = getattr(fn, "__name__", name)
        return wrapper

    return deco
