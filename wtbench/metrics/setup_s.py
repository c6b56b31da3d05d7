"""Seconds from the process's start to the window: generating and writing
the dataset, loading (and in a fresh checkout building) the program, its
set-up archive and the warm-up."""


def read(run):
    return run.setup_s
