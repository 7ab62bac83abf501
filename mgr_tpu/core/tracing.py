"""Profiling/tracing hooks and numerics debugging.

The reference's only instrumentation was a wall-clock print around
fit_generator (speech_lstm_ctc_words.py:181-193). Here:
  * ``annotate(name)`` — jax.profiler trace annotation around a region
    (shows up in xprof/tensorboard device traces).
  * ``trace(logdir)`` — capture a full device trace for a block.
  * ``debug_nans(enable)`` — flip jax_debug_nans (the JAX-native
    replacement for sanitizers; SURVEY.md §5.2).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax


def annotate(name: str):
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def debug_nans(enable: bool = True) -> None:
    jax.config.update("jax_debug_nans", enable)
