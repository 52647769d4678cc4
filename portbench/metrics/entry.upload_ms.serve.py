"""Host ms a request spends in `trace.upload` copying its queries,
im_info and (FSOD) supports to the card, the median over the window's
requests (units.py)."""

from portbench import units


def read(run):
    return units.median(run, 'serve', lambda r: r['upload_ns'] / 1e6)
