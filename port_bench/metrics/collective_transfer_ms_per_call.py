"""Milliseconds of the sharded driver's lockstep collectives per call that
no rank escapes: the least rank's elapsed time at each collective, summed
(the port's lockstep table)."""

from port_bench import spans


def read(s):
    log = spans.port_log()
    got = spans.lockstep_ms(log) if log else None
    return got[0] if got else None
