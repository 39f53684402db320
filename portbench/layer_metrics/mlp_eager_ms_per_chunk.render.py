"""Device ms per traced render chunk of the kernels, copies and sets outside
K1-K6 that the program launched under `durf.model.mlp`: the MLPs' calls
around K1, adding the object outputs."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "eager", ("durf.model.mlp",), "chunks")
