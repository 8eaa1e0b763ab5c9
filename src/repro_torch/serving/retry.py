"""Bounded exponential backoff for ``Overloaded`` sheds, port of
``repro.serving.retry``.

The fleet's admission control turns overload into a *typed, recoverable*
rejection: ``Overloaded`` carries a ``retry_after`` drain-time estimate.
This module is the client half of that contract — retry the shed a bounded
number of times, waiting the larger of the fleet's hint and an exponential
backoff, capped. Everything else (shape errors, closed services) still
raises immediately: only sheds are transient.

Used by ``repro_torch.launch.serve_map --max-retries`` client threads and the
``MapGateway(shed_retries=...)`` dispatcher, and usable directly:

    from repro_torch.serving.retry import call_with_retries
    units = call_with_retries(fleet.transform, x, max_retries=4)
"""
from __future__ import annotations

import time

from repro_torch.serving.fleet import Overloaded

__all__ = ["call_with_retries"]


def call_with_retries(fn, *args, max_retries: int = 3,
                      base_delay: float = 0.05, max_delay: float = 2.0,
                      sleep=time.sleep, on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying ``Overloaded`` sheds.

    Waits ``min(max(retry_after, base_delay * 2**attempt), max_delay)``
    between attempts — the fleet's own drain estimate when it is the
    larger, exponential backoff when the hint is optimistic, never more
    than ``max_delay``. After ``max_retries`` retries the last
    ``Overloaded`` propagates (a persistently saturated fleet should fail
    loudly, not spin). ``sleep`` / ``on_retry(attempt, delay, exc)`` are
    injection points for tests and logging.
    """
    if max_retries < 0:
        raise ValueError(f"max_retries must be >= 0, got {max_retries}")
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Overloaded as exc:
            if attempt >= max_retries:
                raise
            delay = min(max(float(exc.retry_after),
                            base_delay * (2.0 ** attempt)), max_delay)
            if on_retry is not None:
                on_retry(attempt, delay, exc)
            sleep(delay)
            attempt += 1
