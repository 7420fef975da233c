"""Tokens the model generated per second: every call that finished
(prefills and graph captures inside the window) over the window."""


def read(run):
    return run.rate("tokens")
