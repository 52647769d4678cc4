"""Host ms of `Predictor.predict` until the call returns (its detections
still on the card), the median over the window's requests: the
benchmark's own span around the entry point."""

from portbench import harness


def read(run):
    if run.kind != 'serve' or not run.host_ms:
        return None
    return harness.median(run.host_ms)
