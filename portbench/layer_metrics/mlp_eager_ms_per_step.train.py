"""Device ms per traced step of the kernels, copies and sets outside K1-K6 that
the program launched under `durf.model.mlp`: the background or proposal
MLP's call around K1, adding the object outputs, density noise."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "eager", ("durf.model.mlp",), "units")
