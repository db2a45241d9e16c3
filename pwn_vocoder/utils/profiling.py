"""Tracing / profiling / debug-mode helpers (SURVEY.md §5).

Reference: TensorBoard step-time summaries via tensorpack callbacks [R].
Rebuild: `jax.profiler` traces with named step/op annotations, plus a
debug mode that turns on NaN checking (the pure-functional analogue of a
sanitizer — SURVEY.md §5 "race detection / sanitizers": there is no
shared mutable state to race on by construction).

Usage:
    with profiling.trace_step(step):
        state, metrics = train_step(state, batch)

    PWN_PROFILE_DIR=/tmp/prof python -m pwn_vocoder.cli train-teacher ...
        -> captures a profiler trace of steps 10..15 viewable in
           TensorBoard/XProf.

    PWN_DEBUG=1 -> jax_debug_nans (fails fast, locates the op).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import jax

PROFILE_DIR_ENV = "PWN_PROFILE_DIR"
DEBUG_ENV = "PWN_DEBUG"
_PROFILE_START_STEP = 10
_PROFILE_STOP_STEP = 15


def apply_debug_flags() -> None:
    """Enable fail-fast numerics checking when PWN_DEBUG is set."""
    if os.environ.get(DEBUG_ENV):
        jax.config.update("jax_debug_nans", True)


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    with jax.profiler.TraceAnnotation(name):
        yield


class StepProfiler:
    """Captures a profiler trace of a few steady-state steps when
    PWN_PROFILE_DIR is set; no-op otherwise."""

    def __init__(self, logdir: Optional[str] = None):
        self.logdir = logdir or os.environ.get(PROFILE_DIR_ENV)
        self._active = False

    def step(self, step: int) -> None:
        if not self.logdir:
            return
        if step == _PROFILE_START_STEP and not self._active:
            jax.profiler.start_trace(self.logdir)
            self._active = True
        elif step >= _PROFILE_STOP_STEP and self._active:
            jax.profiler.stop_trace()
            self._active = False
            print(f"[profiler] trace written to {self.logdir}")

    def close(self) -> None:
        if self._active:
            jax.profiler.stop_trace()
            self._active = False


def xplane_files(logdir: str):
    """The `.xplane.pb` files a `jax.profiler` trace wrote under logdir."""
    import glob

    return sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                            recursive=True))


def op_times_ns(xplane_path: str,
                plane_prefix: str = "/device:GPU") -> dict:
    """Total duration (ns) per XLA op name in one trace file, over the
    planes whose name starts with `plane_prefix`: the events on a line
    named "XLA Ops", and any other event that carries an `hlo_op` stat."""
    from jax.profiler import ProfileData

    totals: dict = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                if line.name == "XLA Ops" or any(
                        k == "hlo_op" for k, _ in ev.stats):
                    totals[ev.name] = totals.get(ev.name, 0.0) \
                        + ev.duration_ns
    return totals
