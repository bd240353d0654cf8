"""``time_to_deff_s`` in the stream of 100^3 samples, under a bound of its
own: small tensors paced by the host spread more than the 512^3 ones that
``time_to_deff_s`` guards."""

from portbench.end_to_end.time_to_deff_s import read  # noqa: F401
