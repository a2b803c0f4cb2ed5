"""calib.peak_mem_gib: the device memory the window's solves held at their
peak (``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GiB."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
