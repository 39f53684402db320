"""Set-up: from the process's start to the first timed unit, the kernels'
build, the weights, the traffic and the warm-up steps included."""


def read(win):
    return win.setup_s
