"""Structured metrics logging (SURVEY.md §5 "Metrics / logging").

Reference: TensorBoard scalars + tensorpack console logger [R].  Rebuild:
one jsonl line per log event — trivially greppable, drives bench tables —
plus a console mirror, plus (optional) native TensorBoard event files
via utils/tensorboard.py's dependency-free writer.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tb_dir: Optional[str] = None):
        self._file = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a", buffering=1)
        self._echo = echo
        self._t0 = time.time()
        self._tb = None
        if tb_dir:
            from pwn_vocoder.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(tb_dir)

    def log(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {
            "step": int(step),
            "wall_s": round(time.time() - self._t0, 3),
        }
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
        if self._tb:
            self._tb.add_scalars(
                step, **{k: v for k, v in rec.items()
                         if isinstance(v, float) and k != "wall_s"}
            )
            self._tb.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def add_audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        """Emit a TensorBoard audio summary (the reference's audio-
        progress mechanism [R], SURVEY.md:300-304) when a TB dir is
        configured; no-op otherwise."""
        if self._tb:
            self._tb.add_audio(tag, wav, sample_rate, step=step)
            self._tb.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
