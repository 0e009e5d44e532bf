"""Logging setup: klog-style text or structured JSON.

Role of the reference's logging flags bridge (lengrongfu/k8s-dra-driver,
pkg/flags/logging.go:38-88), which wires k8s logsapi's JSON-format option
into the CLI. Here: stdlib logging with an optional JSON formatter.

The JSON formatter is the correlation seam of the observability layer:
``extra={...}`` structured fields are merged into the line, and when a
tracing span is active (utils/tracing.py) the line carries its
``traceId``/``spanId`` and claim UID — so logs, traces, metrics, and
Kubernetes Events all key on the same claim UID.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

# Attributes every LogRecord carries (computed from a dummy record so the
# set tracks the running Python version, e.g. 3.12's taskName); anything
# else on the record arrived via ``extra={...}`` and belongs in the line.
_RESERVED_RECORD_ATTRS = frozenset(
    logging.LogRecord("", 0, "", 0, "", (), None).__dict__
) | {"message", "asctime", "taskName"}


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        # Span correlation: any line logged inside a traced operation
        # carries the ids that find its trace in /debug/traces.
        from .tracing import current_span

        span = current_span()
        if span is not None and span.trace_id:
            out["traceId"] = span.trace_id
            out["spanId"] = span.span_id
            if span.claim_uid:
                out["claimUid"] = span.claim_uid
        for key, value in record.__dict__.items():
            if key in _RESERVED_RECORD_ATTRS or key.startswith("_"):
                continue
            out.setdefault(key, value)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=repr)


def setup_logging(level: str | None = None,
                  json_format: bool | None = None) -> None:
    """Install the root handler.

    ``None`` arguments fall back to the ``TPU_DRA_LOG_LEVEL`` /
    ``TPU_DRA_LOG_FORMAT`` (``json``|``text``) environment overrides — the
    seam that lets a DaemonSet flip to JSON/debug by editing pod env
    without changing the container args. An explicit argument (the CLI
    flag path) always wins over the environment.
    """
    if level is None or level == "":
        level = os.environ.get("TPU_DRA_LOG_LEVEL") or "INFO"
    if json_format is None:
        json_format = (
            os.environ.get("TPU_DRA_LOG_FORMAT", "").strip().lower() == "json"
        )
    handler = logging.StreamHandler(sys.stderr)
    if json_format:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
