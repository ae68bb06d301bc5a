"""Seconds from the process's start to the window's: import, loading the
port's built libraries, the scene's load and tables, one warm-up pass."""


def compute(rec):
    return rec["setup_s"]
