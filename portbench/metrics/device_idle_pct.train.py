"""Percent of the traced window in which no operation ran on the device."""

from portbench import readers


def read(run):
    return readers.idle_pct(run)
