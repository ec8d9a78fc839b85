"""moe_host_ms (ms): host time a prefill call spends in the program's
``forward.moe`` spans (the MoE layers: routing, the sort, the expert products,
the scatter), summed over its layers; the median over the traced slice's
calls, ``lib/forward_spans.py``."""

from perfbench.lib.forward_spans import span_ms


def read(rec):
    return span_ms(rec, "forward.moe")
