"""Window seconds over the whole-volume D_eff tensors completed in it."""


def read(window):
    if window.kind != "effective_diffusivity" or not window.results:
        return None
    return window.seconds / window.results
