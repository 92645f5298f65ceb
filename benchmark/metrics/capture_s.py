"""capture_s: host time of the key's first call, synchronised: the eager
warm-up frame on the capture stream and the graph capture of its segments
(a sequence's first call also renders its frames)."""


def read(r):
    return r.capture_s
