"""torch.cuda.max_memory_allocated() over the window, in GiB."""


def read(run):
    if run.kind != 'serve' or run.device.type != 'cuda':
        return None
    return run.peak_bytes / 2 ** 30
