"""Window seconds over the tau values completed in it."""


def read(window):
    if window.kind != "tortuosity" or not window.results:
        return None
    return window.seconds / window.results
