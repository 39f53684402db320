"""Device ms per traced render chunk of the kernels, copies and sets outside
K1-K6 that the program launched under `durf.model.boxes` and
`durf.model.objects`: the boxes and the object route around K3."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "eager", ("durf.model.boxes", "durf.model.objects"), "chunks")
