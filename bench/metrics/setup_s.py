"""Seconds from the process's start to the window's first query: data made,
tables built and uploaded, server started, executables warmed."""


def read(run):
    return run["setup_s"]
