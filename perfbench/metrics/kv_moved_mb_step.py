"""kv_moved_mb_step (MB): KV bytes a step moves between the tiers, demoted
(device to host) and promoted (host to device), ``kv_d2h_bytes`` +
``kv_h2d_bytes`` on the step, in 1e6 bytes; 0 where nothing moved;
``lib/program_spans.py`` says over what steps."""

from perfbench.lib.program_spans import per_step


def read(rec):
    return per_step(rec, lambda root, kids: (
        root["attrs"].get("kv_d2h_bytes", 0) + root["attrs"].get("kv_h2d_bytes", 0)) / 1e6)
