"""Profiling and tracing (counterpart of :mod:`mrgcn_tpu.utils.profiling`).

  * ``MRGCN_PROFILE_DIR=<dir>`` records a trace of the run with
    ``torch.profiler``: the host's operators, and on a card its kernels
    and copies; a Chrome trace (``trace_<pid>_<time>.json``, viewable in
    Perfetto or ``chrome://tracing``) is written into that directory;
  * :func:`annotate` names a host phase, which shows as a span on the
    trace;
  * :class:`PhaseTimer` sums the wall-clock time of named phases and logs
    a table.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)


def annotate(name: str):
    """A span named ``name`` on the trace (``record_function``; it costs
    next to nothing when no profiler runs)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_session(output_dir: Optional[str] = None,
                    device: Optional[torch.device] = None) -> Iterator[None]:
    """Record a trace into ``output_dir`` (or ``MRGCN_PROFILE_DIR``) when
    one is set, with the card's activity too when ``device`` is a CUDA
    device (by default: when a card is present); otherwise do nothing."""
    output_dir = output_dir or os.environ.get("MRGCN_PROFILE_DIR")
    if not output_dir:
        yield
        return

    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda" if device is not None \
        else torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir,
                        f"trace_{os.getpid()}_{int(time.time())}.json")
    logger.info("Profiling to %s", output_dir)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        logger.info("Trace written to %s", path)


class PhaseTimer:
    """Accumulates wall-clock per phase; ``summary()`` logs a table."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            with annotate(name):
                yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["phase timings:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"  {name}: {self.totals[name]:.2f}s "
                         f"({self.counts[name]} calls)")
        return "\n".join(lines)

    def log_summary(self) -> None:
        logger.info("%s", self.summary())
