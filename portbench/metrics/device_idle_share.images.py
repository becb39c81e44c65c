"""The share of the traced span in which no operation runs on the card:
one less the union of the device intervals over the span, in %."""

from portbench.core.readers import idle_share


def read(run):
    return idle_share(run)
