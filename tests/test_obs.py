"""Observability: logger levels, event timing tree, nesting guard
(reference semantics: logger.hh double-start abort :408-427, report table
:438-497)."""

import io

import pytest

from ddm_jax.obs.logger import Logger, ScopedLog, logger, scoped, setup_loggers


def test_event_timing_and_report():
    Logger.reset()
    ev = Logger.get().register_or_get_event("Fam", "op")
    with ScopedLog(ev):
        pass
    with ScopedLog(ev):
        pass
    assert ev.count == 2
    out = Logger.get().report()
    assert "Fam / op" in out
    # same (family, name) returns the same event object
    assert Logger.get().register_or_get_event("Fam", "op") is ev


def test_double_start_aborts():
    Logger.reset()
    ev = Logger.get().register_or_get_event("F", "x")
    Logger.get().start_event(ev)
    with pytest.raises(RuntimeError, match="started twice"):
        Logger.get().start_event(ev)
    Logger.get().end_event(ev)
    with pytest.raises(RuntimeError, match="without start"):
        Logger.get().end_event(ev)


def test_log_level_parsing():
    rest = setup_loggers(["--log-level=debug", "-gridsize", "4"])
    assert rest == ["-gridsize", "4"]
    assert logger.get_level().name == "debug"
    logger.set_level("info")


def test_scoped_helper():
    Logger.reset()
    with scoped("A", "b"):
        pass
    assert Logger.get().events[("A", "b")].count == 1
