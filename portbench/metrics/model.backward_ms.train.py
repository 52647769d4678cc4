"""Device ms a traced step charged to the program's `dana.backward`
range (the autograd backward, launched from autograd's thread while the
step's thread waits inside the range)."""


def read(run):
    t = run.trace
    if run.kind != 'train' or t is None or not t.device or not t.units:
        return None
    return 1e3 * t.charged_s(lambda n: n == 'dana.backward') / t.units
