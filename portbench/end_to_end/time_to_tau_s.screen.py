"""``time_to_tau_s`` in a screening stream, under a bound of its own:
small host-bound answers spread more than the 512^3 ones that
``time_to_tau_s`` guards."""

from portbench.end_to_end.time_to_tau_s import read  # noqa: F401
