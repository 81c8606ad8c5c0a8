"""Set-up: the process's start to the window's start (imports, CUDA,
the kernel library, the stream rendered, the capture and the warm-up)."""


def read(rec):
    return rec.setup_s
