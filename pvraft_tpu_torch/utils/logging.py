"""Experiment logging (port of ``pvraft_tpu/utils/logging.py``).

The reference's layout and tags: ``<exp_path>/logs`` and
``<exp_path>/checkpoints``, one ``logging`` file per mode,
``logs/<Mode>_<dataset>.log``, and TensorBoard scalars under the
reference's tag names (``Train/Loss``, ``Train/EPE``, ``Val/...``).
:class:`TBWriter` writes through ``torch.utils.tensorboard`` where the
``tensorboard`` package is installed; without it the scalars are kept in
memory only (``history``, which tests and ``chip_smoke.py`` read) and
the run goes on.

The loggers are named ``pvraft_tpu_torch.<Mode>_<dataset>``: a process
that runs both packages keeps their file handlers apart.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Dict, List, Tuple


class TBWriter:
    """TensorBoard scalars, always kept in ``history`` as ``tag ->
    [(step, value)]``; written to ``log_dir`` too where
    ``torch.utils.tensorboard`` imports (``backend`` says which).
    ``enabled=False`` (a process other than rank 0) writes nothing:
    backend ``"off"``."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.history: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        self._writer = None
        if not enabled:
            self.backend = "off"
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir)
        except Exception:  # noqa: BLE001 — no tensorboard: in memory only
            self._writer = None
        self.backend = "tensorboard" if self._writer is not None else "memory"

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.history[tag].append((step, float(value)))
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def close(self) -> None:
        """Flush and release the backend writer. Idempotent, and it never
        raises: a writer that fails while closing must not hide the error
        that ended the run. ``history`` stays readable."""
        writer, self._writer = self._writer, None
        if writer is None:
            return
        for call in (writer.flush, writer.close):
            try:
                call()
            except Exception:  # noqa: BLE001 — see the docstring
                pass


class ExperimentLog:
    """The experiment directory (``logs/``, ``checkpoints/``) and the
    mode's log file ``logs/<mode>_<dataset>.log`` (``<mode>.log`` without
    a dataset), one file handler per path however many instances open
    it. ``enabled=False`` (a process other than rank 0) makes no
    directory and writes no line."""

    def __init__(self, exp_path: str, mode: str = "Train", dataset: str = "",
                 enabled: bool = True):
        self.root = exp_path
        self.log_dir = os.path.join(exp_path, "logs")
        self.ckpt_dir = os.path.join(exp_path, "checkpoints")
        self.enabled = enabled
        name = f"{mode}_{dataset}" if dataset else mode
        self.path = os.path.abspath(os.path.join(self.log_dir, f"{name}.log"))
        self.logger = logging.getLogger(f"pvraft_tpu_torch.{name}")
        if not enabled:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        if not any(isinstance(h, logging.FileHandler)
                   and h.baseFilename == self.path
                   for h in self.logger.handlers):
            handler = logging.FileHandler(self.path)
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
            self.logger.addHandler(handler)

    def info(self, msg: str) -> None:
        if self.enabled:
            self.logger.info(msg)

    def close(self) -> None:
        """Remove and close the logger's file handlers (loggers live for
        the process; without this every Trainer of a long process keeps a
        file open). Idempotent."""
        if not self.enabled:
            return
        for handler in list(self.logger.handlers):
            if isinstance(handler, logging.FileHandler):
                self.logger.removeHandler(handler)
                try:
                    handler.close()
                except Exception:  # noqa: BLE001 — closing must not raise
                    pass
