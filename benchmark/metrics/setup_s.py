"""Process start to the window's start: data, weights, the program's
set-up, kernel builds and loads, the first steps and their capture, in s."""


def read(run: dict):
    return run["setup_s"]
