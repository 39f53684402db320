"""Device ms per traced step of the kernels, copies and sets outside K1-K6 that
the program launched under `durf.step.backward`: autograd's backward around
K2 and K4, and the gradients' sum."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "eager", ("durf.step.backward",), "units")
