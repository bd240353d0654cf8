"""Share of the traced window with nothing on the device (the union
of kernel and copy intervals over every stream), CLI runs."""

from portbench.readers import idle_pct

CLI = ("cli",)


def read(traced):
    return idle_pct(traced, CLI)
