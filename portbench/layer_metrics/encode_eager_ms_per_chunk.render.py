"""Device ms per traced render chunk of the kernels, copies and sets outside
K1-K6 that the program launched under `durf.model.encode`: contraction and
the integrated positional encoding."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "eager", ("durf.model.encode",), "chunks")
