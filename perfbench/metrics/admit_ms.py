"""admit_ms (ms): host time a step spends in ``engine.admit`` (the walk of queued
and preempted requests, their pages allocated or promoted, evictions);
``lib/program_spans.py`` says over what steps."""

from perfbench.lib.program_spans import span_ms


def read(rec):
    return span_ms(rec, "engine.admit")
