"""Depth-indented logger for nested search recursion.

The PyTorch counterpart of flexflow_tpu/utils/recursive_logger.py
(reference: src/runtime/recursive_logger.cc, TAG_ENTER/TAG_EXIT depth
markers around the DP search's recursive splits): a context manager
that indents records by recursion depth; silent unless the logger is
enabled for DEBUG, so the search pays one isEnabledFor check per scope.
"""
from __future__ import annotations

import contextlib
import logging

logger = logging.getLogger("flexflow_tpu_torch.search")


class RecursiveLogger:
    def __init__(self, log: logging.Logger = logger):
        self.log = log
        self.depth = 0

    @contextlib.contextmanager
    def enter(self, msg: str, *args):
        """Log `msg` at the current depth, then deepen for the scope."""
        if self.log.isEnabledFor(logging.DEBUG):
            self.log.debug("%s%s", "  " * self.depth, msg % args if args else msg)
        self.depth += 1
        try:
            yield self
        finally:
            self.depth -= 1

    def info(self, msg: str, *args):
        if self.log.isEnabledFor(logging.DEBUG):
            self.log.debug("%s%s", "  " * self.depth, msg % args if args else msg)


# module-level instance shared by the search passes (the reference keeps
# one RecursiveLogger per search invocation; depth is reentrant here)
search_logger = RecursiveLogger()
