"""Window seconds over the tau values completed in it by runs of the
CLI (each run also reads the stack, counts the volume fraction and writes
``results.txt``: its own metric, apart from ``time_to_tau_s``)."""


def read(window):
    if window.kind != "cli" or not window.results:
        return None
    return window.seconds / window.results
