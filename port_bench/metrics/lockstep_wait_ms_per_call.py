"""Milliseconds a rank waits in the sharded driver's lockstep collectives
per call: each rank's elapsed time at each collective less the least
rank's, summed, averaged over ranks (the port's lockstep table)."""

from port_bench import spans


def read(s):
    log = spans.port_log()
    got = spans.lockstep_ms(log) if log else None
    return got[1] if got else None
