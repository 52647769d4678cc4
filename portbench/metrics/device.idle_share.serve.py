"""The share of the traced requests' service time in which no kernel, copy
or memset ran on the card, in %: 1 - the union of the device intervals
over the service intervals (tracing.py)."""


def read(run):
    t = run.trace
    if run.kind != 'serve' or t is None or not t.device or not t.window_s():
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
