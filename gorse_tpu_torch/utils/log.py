"""Logging with secrets redacted (port of gorse_tpu/utils/log.py).

As gorse's common/log (log.go:68-228): a shared logger factory, credentials
redacted from database URLs and key=value pairs, and a logger of its own
for the OpenAI prompts and completions, which can write to a file.
"""

from __future__ import annotations

import logging
import re
import sys

_REDACT_URL = re.compile(r"(\w+://)([^:/@\s]+):([^@/\s]+)@")
_REDACT_KEYS = re.compile(
    r"((?:api[-_]?key|auth[-_]?token|password|secret)['\"]?\s*[:=]\s*['\"]?)([^'\"\s,}]+)",
    re.IGNORECASE,
)


def redact(text: str) -> str:
    """Strip credentials from URLs (``scheme://user:pass@``) and obvious
    secret-bearing key=value pairs (reference: log.RedactDBURL,
    common/log/log.go:155-176)."""
    text = _REDACT_URL.sub(r"\1\2:xxxxx@", text)
    return _REDACT_KEYS.sub(r"\1xxxxx", text)


class RedactingFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        return redact(super().format(record))


def setup_logging(level: int = logging.INFO, openai_log_file: str = "") -> None:
    """Install the root handler with redaction + the dedicated OpenAI
    prompt logger (reference: log.OpenAILogger, common/log/log.go:188-202)."""
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        RedactingFormatter("%(asctime)s %(levelname)s %(name)s %(message)s")
    )
    root = logging.getLogger()
    root.handlers = [handler]
    root.setLevel(level)
    openai_logger = logging.getLogger("gorse_tpu.openai")
    if openai_log_file:
        fh = logging.FileHandler(openai_log_file)
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        openai_logger.handlers = [fh]
        openai_logger.propagate = False
    else:
        # prompts are verbose; keep them out of the main log by default
        openai_logger.setLevel(logging.WARNING)


def logger(name: str) -> logging.Logger:
    return logging.getLogger(f"gorse_tpu.{name}")
