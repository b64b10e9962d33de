"""peak_mem_gib: the allocator's peak over the window
(``torch.cuda.max_memory_allocated``, reset after the warm-up), in GiB."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None
