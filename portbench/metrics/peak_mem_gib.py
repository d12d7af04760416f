"""The most device memory the window's blocks held above what was
allocated when it opened (the input pool), by the allocator's peak
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    if ctx.block_peak_bytes is None or not ctx.block_s:
        return None
    return ctx.block_peak_bytes / 2**30
