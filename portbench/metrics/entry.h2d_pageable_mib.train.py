"""MiB a step copies from pageable host memory to the card inside
`Trainer.step` (`trace.upload`: the batch and the draws; the counter
`h2d_pageable_bytes`), the median over the window's steps (units.py)."""

from portbench import units


def read(run):
    return units.median(run, 'train', lambda r: r['counts'].get(
        'h2d_pageable_bytes', 0) / 2 ** 20)
