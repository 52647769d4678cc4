"""torch.cuda.max_memory_allocated() over the window, in GiB."""


def read(run):
    if run.kind != 'train' or run.device.type != 'cuda':
        return None
    return run.peak_bytes / 2 ** 30
