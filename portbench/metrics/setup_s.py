"""setup_s: seconds from the process start to the end of the warm-up:
imports, the kernel build or load, the system, the warm-up."""


def read(run):
    return run.setup_s
