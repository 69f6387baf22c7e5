"""Distributed-aware logger.

The counterpart of ``pipegoose_tpu/trainer/logger.py``: a named logger
that only one rank emits from (rank 0 by default), the rank read from
``torch.distributed`` through ``utils.procindex.RankFilter``.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

from pipegoose_tpu_torch.utils.procindex import RankFilter


class DistributedLogger:
    def __init__(
        self,
        name: str = "pipegoose_tpu_torch",
        rank: Optional[int] = 0,
        level: int = logging.INFO,
        logfile: Optional[str] = None,
    ):
        """``rank``: only this rank logs; None = every rank."""
        self.name = name
        self.rank = rank
        self._rank_ok = RankFilter(rank)
        self._logger = logging.getLogger(name)
        self._logger.setLevel(level)
        self._logger.propagate = False  # no second copy through the root logger
        fmt = logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s")
        if not any(
            isinstance(h, logging.StreamHandler)
            and not isinstance(h, logging.FileHandler)
            for h in self._logger.handlers
        ):
            h = logging.StreamHandler(sys.stdout)
            h.setFormatter(fmt)
            self._logger.addHandler(h)
        if logfile and not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == os.path.abspath(logfile)
            for h in self._logger.handlers
        ):
            fh = logging.FileHandler(logfile)
            fh.setFormatter(fmt)
            self._logger.addHandler(fh)

    def _should_log(self) -> bool:
        return self._rank_ok()

    def info(self, msg: str) -> None:
        if self._should_log():
            self._logger.info(msg)

    def warning(self, msg: str) -> None:
        if self._should_log():
            self._logger.warning(msg)

    def error(self, msg: str) -> None:
        if self._should_log():
            self._logger.error(msg)

    def debug(self, msg: str) -> None:
        if self._should_log():
            self._logger.debug(msg)
