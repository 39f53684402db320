"""Device ms per traced step of the kernels, copies and sets outside K1-K6 that
the program launched under `durf.model.sample`: sampling along the rays
(stratified, inverse-CDF or grid)."""

from portbench import spans


def read(s):
    return spans.ms_per(s, "eager", ("durf.model.sample",), "units")
