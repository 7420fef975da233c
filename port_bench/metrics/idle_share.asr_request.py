"""The traced window's share, in %, in which no device operation ran."""


def read(run):
    return run.idle_share()
