"""How every ``<kernel>_roofline.<serve|batch|train>`` is read (the kernel's own
``<kernel>_roofline.py`` takes ``read`` from here): a kernel's share of its roofline
in the traced window, in %: the sum of its calls' bounds (``perfbench.costs`` at
each call's inputs, or the kernel's file in ``perfbench/kernels``: the larger of bytes
over the HBM bandwidth and operations over the card's peak for the type of the call's
operands) over the device time of its launches, matched by kernel symbol.
Nothing where the kernel had no call or no device time (the harness then fails the
traced run)."""
def read(name, record):
    kernel = name.split(".")[0][:-len("_roofline")]
    calls = record.kernel_costs.get(kernel)
    if not calls or record.device is None:
        return None
    seconds = record.device.kernel_seconds().get(kernel, 0.0)
    if seconds <= 0.0:
        return None
    return 100.0 * sum(c.bound_s() for c in calls) / seconds
