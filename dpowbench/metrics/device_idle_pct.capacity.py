"""device_idle_pct.capacity: the share of the traced window in which no
kernel, copy or memset ran on the card (%)."""

from dpowbench.readers import idle_pct


def read(src):
    return idle_pct(src)
