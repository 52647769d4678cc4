"""Host ms a step spends in `trace.upload` copying its batch and draws to
the card (the range `dana.entry.upload`), the median over the window's
steps (units.py)."""

from portbench import units


def read(run):
    return units.median(run, 'train', lambda r: r['upload_ns'] / 1e6)
