"""Sequence-frames whose poses reached the host, summed over the
sequences, over the whole measured time, the last chunk's end included."""


def read(rec):
    if rec.window_s <= 0:
        return None
    return rec.frames / rec.window_s
