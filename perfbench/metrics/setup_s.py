"""setup_s (s): process start to the window's start, by the host clock."""


def read(rec):
    return rec.setup_s
