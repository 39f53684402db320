"""Device ms per traced step of the kernels, copies and sets outside K1-K6 that
the program launched under `durf.model.boxes` and `durf.model.objects`: the
boxes (frames, ray-box hits, near/far, view encoding) and the object route
(compaction, windowed IPE, the per-ray condition, the scatter, the centroid,
the background mask)."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "eager", ("durf.model.boxes", "durf.model.objects"), "units")
