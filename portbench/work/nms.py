"""The NMS kernel's bytes: the score-sorted boxes and their validity read
once, the kept positions (int64) and mask written once.  Its operations
depend on how many boxes the walk needs and are not counted."""


def nbytes(b, n, m):
    return b * n * (16 + 1) + b * m * (8 + 1)
