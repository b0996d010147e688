"""setup_s: from the start of the process to the first timed step (host
clock): imports, the kernel build where it is not cached, the seeded inputs,
the program's set-up and the warm-up of every shape the cell uses."""


def read(run):
    return run.setup_s or None
