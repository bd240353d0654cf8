"""The most device memory allocated during the window, in 1e9 bytes."""


def read(window):
    return window.peak_bytes / 1e9 if window.peak_bytes else None
