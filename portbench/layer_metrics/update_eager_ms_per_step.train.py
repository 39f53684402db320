"""Device ms per traced step of the kernels, copies and sets outside K1-K6 that
the program launched under `durf.step.update`: gradient hygiene, Adam, the
grid update and the step's stats."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "eager", ("durf.step.update",), "units")
