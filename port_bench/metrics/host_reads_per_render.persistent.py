"""The port's ``persistent.HOST_READS`` (device-to-host reads of the
persistent loop) over the window, per call."""


def read(s):
    return s["host_reads"] / len(s["walls"])
