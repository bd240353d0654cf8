"""Window seconds over the tau values completed in it, in a screening
stream (its bound is its own: small host-bound answers spread more than
the 512^3 ones that ``time_to_tau_s`` guards)."""


def read(window):
    if window.kind != "tortuosity" or not window.results:
        return None
    return window.seconds / window.results
