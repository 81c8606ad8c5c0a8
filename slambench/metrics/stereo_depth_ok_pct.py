"""Share of the active landmark slots whose stereo depth the frame step
accepted, over the window's chunks: Σ `stereo_ok` / Σ `active` of the
chunk.fetch spans (the frame step's per-frame depth counts, summed at each
chunk's one fetch).  A program without those counts gives None."""

import program_spans


def read(rec):
    w = program_spans.window(rec)
    if w is None:
        return None
    fetches = [s for s in w[0] if s.name == "chunk.fetch" and "stereo_ok" in s.attrs]
    active = sum(s.attrs.get("active", 0) for s in fetches)
    if not active:
        return None
    return 100.0 * sum(s.attrs["stereo_ok"] for s in fetches) / active
