"""Scene pixels (land included) inverted in the window, per second of it,
in millions: all the window's work over all its time."""


def read(run):
    return run.pixels / run.window_s / 1e6
