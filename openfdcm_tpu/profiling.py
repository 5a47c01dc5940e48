"""Tracing / per-stage timing (SURVEY.md §5).

The reference has no tracing hooks (notebooks time externally); here every
pipeline stage can be wrapped in a ``stage(...)`` block that both annotates
the XLA profiler timeline (visible in TensorBoard / ``jax.profiler`` traces)
and accumulates host wall time per stage name.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

_totals: dict = defaultdict(float)
_counts: dict = defaultdict(int)


@contextlib.contextmanager
def stage(name: str, sync: bool = False):
    """Annotate + time a pipeline stage.

    ``sync=True`` blocks on all device work before stopping the clock (use
    for leaf stages; otherwise dispatch is asynchronous and wall time only
    covers the host side).
    """
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    if sync:
        try:
            (jax.device_put(0) + 0).block_until_ready()
        except Exception:  # pragma: no cover
            pass
    _totals[name] += time.perf_counter() - t0
    _counts[name] += 1


def report() -> dict:
    """Per-stage ``{name: (total_s, calls)}`` accumulated so far."""
    return {k: (_totals[k], _counts[k]) for k in _totals}


def reset() -> None:
    _totals.clear()
    _counts.clear()


def start_trace(log_dir: str) -> None:
    """Start an XLA profiler trace (view with TensorBoard)."""
    jax.profiler.start_trace(log_dir)


def stop_trace() -> None:
    jax.profiler.stop_trace()


def card_info() -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` reports them
    (``--query-gpu=name,power.limit --format=csv,noheader``), one line per
    card, or ``"unavailable (...)"`` where there is no ``nvidia-smi``.
    Times taken on a card are only comparable at the same power limit."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    return r.stdout.strip() or f"unavailable (rc {r.returncode})"
