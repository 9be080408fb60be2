"""Idle share of the device in a bulk cell's traced window."""
from portbench.metrics._idle import idle


def read(obs):
    return idle(obs)
