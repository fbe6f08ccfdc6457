"""setup_s: host seconds from the harness's first line to the start of the
first timed run: imports, CUDA's start, the federations made on the
device, the warm-up run (one capture of the round program)."""


def read(run):
    return run.setup_s
