"""Process start to the window's start: imports, the world build with its
river network, the members' initial states and the warm-up. The kernel
library's build, which only a checkout's first run makes, is left out and
reported apart (the result's ``kernel_build_s``)."""


def read(run):
    return run.setup_s
