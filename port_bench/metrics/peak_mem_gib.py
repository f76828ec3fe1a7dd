"""torch.cuda.max_memory_allocated() over warm-up and window (reset
before the warm-up), the largest rank, in GiB."""


def read(s):
    return s["peak_alloc_bytes"] / 2 ** 30 if s["peak_alloc_bytes"] else None
