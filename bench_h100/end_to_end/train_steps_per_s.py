"""train_steps_per_s: every step of the window, densify steps included,
over the window's whole time."""


def read(res):
    if res["kind"] != "train":
        return None
    return res["attempted"] / res["elapsed_s"]
