"""K1 at the step's three attention sites, K3 and NMS of a step: their
least time over their device time, in % (shares.py)."""

from portbench import shares


def read(run):
    return shares.roofline(run, 'train')
