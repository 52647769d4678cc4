"""Host ms a step spends blocked in its host syncs (`trace.sync`: the
wait for the device to reach the value read), the median over the
window's steps (units.py).  Near 0: the host issues work no faster than
the card runs it (launch-bound); large: the host waits on the card."""

from portbench import units


def read(run):
    return units.median(run, 'train', lambda r: r['sync_wait_ns'] / 1e6)
