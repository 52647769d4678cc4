"""K1 (where the configuration has attention sites), K2 and NMS of a
request: their least time over their device time, in % (shares.py)."""

from portbench import shares


def read(run):
    return shares.roofline(run, 'serve')
