"""Seconds from the process's start (the first line of run.py) to the
start of the window: imports, reaching the card, building the kernels
(first run in a checkout), weights, inputs, the route's set-up and the
warm-up."""


def read(ctx):
    return ctx.setup_s
