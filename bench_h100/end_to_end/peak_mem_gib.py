"""peak_mem_gib: the device allocator's peak from the window's opening to
its close (`torch.cuda.max_memory_allocated()`), in GiB."""


def read(res):
    return res["window_peak"] / 2 ** 30
