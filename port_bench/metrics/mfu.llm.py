"""Model FLOPs of the traced calls (real windows, rows and tokens; no
padding) over the traced window, as a share of the H100's bf16 peak."""


def read(run):
    return run.mfu()
