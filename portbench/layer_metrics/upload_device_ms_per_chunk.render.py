"""Device ms per traced render chunk of every kernel, copy and set the program
launched under `durf.render.upload`: the chunk's rays and boxes copied to
the card."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "device", ("durf.render.upload",), "chunks")
