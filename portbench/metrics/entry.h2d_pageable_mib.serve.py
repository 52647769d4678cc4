"""MiB a request copies from pageable host memory to the card inside
`Predictor.predict` (`trace.upload`: numpy arrays and unpinned tensors;
the counter `h2d_pageable_bytes`), the median over the window's requests
(units.py)."""

from portbench import units


def read(run):
    return units.median(run, 'serve', lambda r: r['counts'].get(
        'h2d_pageable_bytes', 0) / 2 ** 20)
