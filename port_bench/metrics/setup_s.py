"""Seconds from the process's start to the end of the warm-up call (all
ranks ready)."""


def read(s):
    return s["setup_s"]
