"""``device_idle_share.<serve|batch|train>``: the share of the traced window in which
no kernel ran on the card, in %: 1 - (the union of kernel intervals / the window)."""


def read(name, record):
    tr = record.device
    if tr is None or tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
