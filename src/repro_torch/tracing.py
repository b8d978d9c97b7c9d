"""Named spans at the port's layer boundaries, on the profiler's clock.

``span(name)`` marks a stretch of host work. While a ``torch.profiler``
profile is running it is a ``record_function`` range, so the span lands
in the profiler's own trace beside the device operations it launched and
on their clock (``export_chrome_trace`` writes it as a
``user_annotation`` event). At all other times it is one shared null
context, which costs a module-flag read: ``record_function`` itself
costs microseconds even with no profiler running.

There is no switch, clock or store of its own: run any entry point under
``torch.profiler.profile`` and the spans appear. Span names are dotted
(``engine.ingest``, ``routing.build``, ``intersection.newton``, ...) and
never ``step``, the name a benchmark's trace reader takes for its window.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name`` in the running profile, or the
    shared null context when no profile is running."""
    # the module flag that profile.start() sets for every thread
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
