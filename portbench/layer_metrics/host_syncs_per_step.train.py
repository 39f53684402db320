"""Host waits for the device per traced step: stream, device and event
synchronizations and synchronous copies, the benchmark's own left out."""


def read(s):
    return s.host_syncs / s.units
