"""Host ms of `Trainer.step` until the call returns (it reads the
non-finite flag back, so the step is done), the median over the window's
steps: the benchmark's own span around the entry point."""

from portbench import harness


def read(run):
    if run.kind != 'train' or not run.host_ms:
        return None
    return harness.median(run.host_ms)
