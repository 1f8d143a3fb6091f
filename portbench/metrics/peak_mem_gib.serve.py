"""peak_mem_gib.serve: ``torch.cuda.max_memory_allocated()`` over the traced
run's calls, after ``reset_peak_memory_stats()``, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
