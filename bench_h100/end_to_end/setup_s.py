"""setup_s: seconds from the process's start to the window's opening
(kernels from the checkout's cache, inputs made on the card, the capacity
probe, ground truth, warm-up)."""


def read(res):
    return res["setup_s"]
