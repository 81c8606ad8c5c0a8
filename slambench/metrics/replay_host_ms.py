"""Host milliseconds a CapturedStep.replay call holds the host (no sync),
over every replay of the window."""


def read(rec):
    t = rec.trace
    if t is None or not t.replays:
        return None
    return 1e3 * t.replay_s / t.replays
