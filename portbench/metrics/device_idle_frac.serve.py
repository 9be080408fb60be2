"""Idle share of the device in a serving cell's traced window."""
from portbench.metrics._idle import idle


def read(obs):
    return idle(obs)
