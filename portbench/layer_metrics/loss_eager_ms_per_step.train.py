"""Device ms per traced step of the kernels, copies and sets outside K1-K6 that
the program launched under `durf.step.loss`: the losses, weight decay and
the previous pose."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "eager", ("durf.step.loss",), "units")
