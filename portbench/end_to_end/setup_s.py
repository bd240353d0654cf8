"""Seconds from the start of the process to the start of the window."""


def read(window):
    return window.setup_s
