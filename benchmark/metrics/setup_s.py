"""setup_s (s): from the process's start to the window's first timed
picture: imports, library loads (and, in a checkout's first run, the
kernels' and the host library's builds), lane construction, warm-up."""


def read(w):
    return w.setup_s
