"""A whole step's share of the card's float32 peak, in % (shares.py)."""

from portbench import shares


def read(run):
    return shares.mfu(run, 'train')
