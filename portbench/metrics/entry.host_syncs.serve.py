"""Host syncs a request: reads of a device value by the host inside
`Predictor.predict` (`trace.sync`, the counter `host_syncs`), the median
over the window's requests (units.py)."""

from portbench import units


def read(run):
    return units.median(run, 'serve',
                        lambda r: r['counts'].get('host_syncs', 0))
