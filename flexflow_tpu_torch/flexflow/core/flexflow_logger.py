"""reference python/flexflow/core/flexflow_logger.py: the `fflogger`
console logger (INFO to stdout, ERROR and above to stderr) that
reference scripts and the keras_exp frontend import."""
import logging
import sys


class ConsoleHandler(logging.StreamHandler):
    """stdout for routine records, stderr for ERROR and above (reference:
    flexflow_logger.py ConsoleHandler)."""

    def emit(self, record):
        self.stream = sys.stderr if record.levelno >= logging.ERROR else sys.stdout
        logging.StreamHandler.emit(self, record)

    def flush(self):
        if (self.stream and hasattr(self.stream, "flush")
                and not getattr(self.stream, "closed", False)):
            logging.StreamHandler.flush(self)


def setup_custom_logger(name):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = 0
    if not logger.handlers:
        formatter = logging.Formatter(
            fmt="%(levelname)s - %(module)s - %(message)s"
        )
        ch = ConsoleHandler()
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(formatter)
        logger.addHandler(ch)
    return logger


fflogger = setup_custom_logger("fflogger")
