"""device_busy_ms.gym: device-busy ms a step over the traced env.step()
calls; the step's wall time less this is the host's share."""
from portbench import readers


def read(ctx):
    return readers.busy_ms(ctx, "window")
