"""peak_gib (device): ``torch.cuda.max_memory_allocated()`` over the run
up to the window's close, in GiB (the reference runs after it is read)."""


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None
