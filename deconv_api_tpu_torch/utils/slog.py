"""Structured JSON-lines event logging (a copy of
``deconv_api_tpu/utils/slog.py``).

SURVEY §5's tracing row calls for per-stage timings in structured logs
alongside the /metrics aggregates (the reference's only observability was
debug prints, app/deepdream.py:438,445-447).  Metrics answer "how is the
fleet doing"; these logs answer "what did THIS request/batch do" — one
JSON object per line on stderr, trivially greppable and ingestible.

Usage:
    from deconv_api_tpu_torch.utils import slog
    log = slog.get_logger()
    slog.event(log, "batch_done", key="block5_conv1", size=8, ms=42.1)

`DECONV_LOG_LEVEL` sets the threshold (default INFO; set WARNING to
silence per-request access lines under load testing, or DEBUG for
dispatcher internals).  Lazily configured once, on the "deconv" logger —
applications embedding the library can attach their own handlers instead.
"""

from __future__ import annotations

import json
import logging
import os
import sys

_CONFIGURED = False


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "event": record.getMessage(),
        }
        fields = getattr(record, "fields", None)
        if fields:
            payload.update(fields)
        if "id" not in payload:
            # Any line emitted inside a traced
            # request's context inherits that request's id, so ad-hoc
            # handler/engine log lines join access logs, error payloads
            # and /v1/debug/requests traces without each call site
            # remembering to thread the id through.  Lazy import keeps
            # utils importable without the serving layer; formatting
            # only runs for records that passed the level threshold.
            try:
                from deconv_api_tpu_torch.serving.trace import current_trace

                tr = current_trace()
                if tr is not None:
                    payload["id"] = tr.id
            except ImportError:  # pragma: no cover — partial installs
                pass
        if record.exc_info and record.exc_info[0] is not None:
            payload["exc"] = self.formatException(record.exc_info).splitlines()[-1]
        return json.dumps(payload, default=str)


def configure() -> None:
    """Attach the JSON stderr handler to the "deconv" logger tree.

    Called by the SERVER/CLI entrypoints only — importing library modules
    never configures logging, so an embedding application's own handlers
    and propagation rules stay in charge (its root config receives deconv
    records untouched until/unless it calls this).  Idempotent."""
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger("deconv")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_JsonFormatter())
    root.addHandler(handler)
    wanted = os.environ.get("DECONV_LOG_LEVEL", "INFO").upper()
    if not isinstance(logging.getLevelName(wanted), int):
        # unknown level string must not crash the server at startup
        wanted = "INFO"
    root.setLevel(wanted)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str = "deconv") -> logging.Logger:
    """Plain logger lookup — no configuration side effects (see
    ``configure``).  Without configure(), INFO events follow the
    application's own logging setup (and are dropped under Python's
    default WARNING root, keeping the library quiet by default)."""
    return logging.getLogger(name)


def event(
    logger: logging.Logger, name: str, level: int = logging.INFO, **fields
) -> None:
    """One structured event — `name` plus arbitrary JSON-serialisable
    fields.  Timestamps are added by the formatter; durations should be
    passed pre-rounded (e.g. ``ms=round(dt * 1e3, 1)``)."""
    if logger.isEnabledFor(level):
        logger.log(level, name, extra={"fields": fields})
