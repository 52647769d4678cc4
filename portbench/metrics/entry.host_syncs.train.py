"""Host syncs a step: reads of a device value by the host inside
`Trainer.step` (`trace.sync`, the counter `host_syncs`), the median over
the window's steps (units.py)."""

from portbench import units


def read(run):
    return units.median(run, 'train',
                        lambda r: r['counts'].get('host_syncs', 0))
