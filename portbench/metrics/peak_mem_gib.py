"""torch.cuda.max_memory_allocated() over the whole process up to the end
of the window, set-up included, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
