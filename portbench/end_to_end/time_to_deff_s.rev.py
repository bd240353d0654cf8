"""Window seconds over the REV crops' D_eff tensors completed in it."""


def read(window):
    if window.kind != "rev_study" or not window.results:
        return None
    return window.seconds / window.results
