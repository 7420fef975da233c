"""Rows decoded per window: the greedy decodes' rows over the windows of
the calls (6 where every window is retried at each temperature)."""


def read(run):
    done = [c for c in run.finished if c.index in run.entry.decodes]
    rows = sum(r for c in done for _, _, r in run.entry.decodes[c.index])
    windows = sum(c.work["windows"] for c in done)
    return rows / windows if rows and windows else None
