"""Logging and event timing (observability layer).

Rebuilds the reference's two observability pieces (dune/ddm/logger.hh):

* the ``logger::`` namespace — leveled, ``{}``-formatted messages, level from
  the ``LOG_LEVEL`` env var (logger.hh:57-67) or a ``--log-level=`` CLI flag
  (logger.hh:557-580);
* the ``Logger`` singleton — families -> events with start/end pairs, a
  nesting guard that rejects double-start (logger.hh:408-427), RAII scoped
  timing (logger.hh:328-343) and a mean/min/max report (logger.hh:438-497).

Differences by design: there are no MPI ranks, so the rank-0 vs ``_all``
variants collapse into one, and the report reduces over *calls* rather than
ranks.  Device work is asynchronous under JAX; timed regions that include
device computation should pass ``block=True`` (calls
``jax.block_until_ready``) or wrap values explicitly — otherwise an event
measures dispatch time only.
"""

from __future__ import annotations

import enum
import os
import sys
import time
from dataclasses import dataclass, field


class Level(enum.IntEnum):
    trace = 0
    debug = 1
    info = 2
    warn = 3
    error = 4
    critical = 5
    off = 6


_LEVEL_NAMES = {l.name: l for l in Level}


class _Logger:
    def __init__(self) -> None:
        env = os.environ.get("LOG_LEVEL", "info").lower()
        self.level: Level = _LEVEL_NAMES.get(env, Level.info)
        self.stream = sys.stderr

    def set_level(self, level: Level | str) -> None:
        if isinstance(level, str):
            level = _LEVEL_NAMES[level.lower()]
        self.level = level

    def get_level(self) -> Level:
        return self.level

    def _log(self, level: Level, fmt: str, *args) -> None:
        if level < self.level:
            return
        msg = fmt.format(*args) if args else fmt
        print(f"[{level.name}] {msg}", file=self.stream)

    def trace(self, fmt, *a):
        self._log(Level.trace, fmt, *a)

    def debug(self, fmt, *a):
        self._log(Level.debug, fmt, *a)

    def info(self, fmt, *a):
        self._log(Level.info, fmt, *a)

    def warn(self, fmt, *a):
        self._log(Level.warn, fmt, *a)

    def error(self, fmt, *a):
        self._log(Level.error, fmt, *a)

    def critical(self, fmt, *a):
        self._log(Level.critical, fmt, *a)

    # single-process: the *_all variants are aliases
    trace_all = trace
    debug_all = debug
    info_all = info
    warn_all = warn
    error_all = error


logger = _Logger()


def setup_loggers(argv: list[str] | None = None) -> list[str]:
    """Parse and consume ``--log-level=<lvl>`` from argv (logger.hh:557-580)."""
    if argv is None:
        return []
    rest = []
    for a in argv:
        if a.startswith("--log-level="):
            logger.set_level(a.split("=", 1)[1])
        else:
            rest.append(a)
    return rest


@dataclass
class Event:
    family: str
    name: str
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0
    _start: float | None = field(default=None, repr=False)

    def record(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)


class Logger:
    """Event-timing singleton, mirroring the reference's ``Logger``."""

    _instance: "Logger | None" = None

    def __init__(self) -> None:
        self.events: dict[tuple[str, str], Event] = {}

    @classmethod
    def get(cls) -> "Logger":
        if cls._instance is None:
            cls._instance = Logger()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = Logger()

    def register_or_get_event(self, family: str, name: str) -> Event:
        return self.events.setdefault((family, name), Event(family, name))

    # camelCase alias to mirror the reference API name
    registerOrGetEvent = register_or_get_event

    def start_event(self, ev: Event) -> None:
        if ev._start is not None:
            raise RuntimeError(
                f"Event '{ev.family}/{ev.name}' started twice without end"
            )
        ev._start = time.perf_counter()

    def end_event(self, ev: Event, block_on=None) -> None:
        if ev._start is None:
            raise RuntimeError(f"Event '{ev.family}/{ev.name}' ended without start")
        if block_on is not None:
            import jax

            jax.block_until_ready(block_on)
        ev.record(time.perf_counter() - ev._start)
        ev._start = None

    startEvent = start_event
    endEvent = end_event

    def report(self, stream=None) -> str:
        """Per-family table of total/mean/min/max seconds and call counts."""
        lines = []
        fam_order: list[str] = []
        for (fam, _), _ev in self.events.items():
            if fam not in fam_order:
                fam_order.append(fam)
        header = f"{'event':<42} {'calls':>6} {'total':>10} {'mean':>10} {'min':>10} {'max':>10}"
        lines.append(header)
        lines.append("-" * len(header))
        for fam in fam_order:
            for (f, name), ev in self.events.items():
                if f != fam or ev.count == 0:
                    continue
                mean = ev.total / ev.count
                lines.append(
                    f"{fam + ' / ' + name:<42} {ev.count:>6} {ev.total:>10.4f} "
                    f"{mean:>10.4f} {ev.min:>10.4f} {ev.max:>10.4f}"
                )
        out = "\n".join(lines)
        if stream is not None:
            print(out, file=stream)
        return out


class ScopedLog:
    """RAII-style scoped timing (reference: Logger::ScopedLog).

    Usable as a context manager::

        with ScopedLog(ev, block_on=lambda: result):
            result = step(x)
    """

    def __init__(self, event: Event, block_on=None):
        self.event = event
        self.block_on = block_on

    def __enter__(self):
        Logger.get().start_event(self.event)
        return self

    def __exit__(self, *exc):
        block = self.block_on() if callable(self.block_on) else self.block_on
        Logger.get().end_event(self.event, block_on=block)
        return False


def scoped(family: str, name: str) -> ScopedLog:
    return ScopedLog(Logger.get().register_or_get_event(family, name))


class profile_trace:
    """Context manager wrapping ``jax.profiler.trace`` — device-level traces
    complementing the host-side event tree (SURVEY.md §5.1: "same event-tree
    concept around jitted phases, plus jax.profiler traces").

        with profile_trace("/tmp/ddm_trace"):
            solve(...)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        import jax

        jax.profiler.start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        import jax

        jax.profiler.stop_trace()
        return False
