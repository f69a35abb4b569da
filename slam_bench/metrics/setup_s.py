"""Set-up: process start to the window's start (imports, CUDA start, the
blend libraries, the frame pool, the warm-up, the window's system)."""


def read(rec):
    return rec["setup_s"]
