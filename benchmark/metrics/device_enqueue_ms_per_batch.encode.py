"""device_enqueue_ms_per_batch: the mean wall time of the package's
`device.program` spans, one per device batch: the host's enqueue of the
device program, up to the call's return (not the device's end)."""

from benchmark.harness.program import mean_wall_ms


def read(r):
    return mean_wall_ms(r, "device.program")
