"""engine_host_ms (ms): host time of a ``ServingEngine.step`` outside its
``paged_decode_step`` call (which, traced, ends in a sync and so holds the
device's work), averaged over the window's steps."""


def read(rec):
    spans = rec.data.get("spans")
    if not spans or not spans["steps"]:
        return None
    decodes = spans["decodes"]
    total, j = 0.0, 0
    for a, b in spans["steps"]:
        inside = 0.0
        while j < len(decodes) and decodes[j][0] < b:
            if decodes[j][0] >= a:
                inside += decodes[j][1] - decodes[j][0]
            j += 1
        total += (b - a) - inside
    return total / len(spans["steps"]) * 1e3
