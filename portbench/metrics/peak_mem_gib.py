"""The device memory the caching allocator held at most during the
window, in GiB (``torch.cuda.max_memory_reserved`` after emptying the cache
and resetting the peak at its start). It takes in the CUDA graphs' private
pools, whose blocks count as reserved, not allocated, between replays."""


def read(ctx):
    b = ctx.get("peak_mem_bytes")
    return None if b is None else b / 2 ** 30
