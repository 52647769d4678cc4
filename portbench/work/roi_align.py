"""RoIAlign's bytes (K2 when serving, K3 in training): the map read once,
the rois (or, for K3, the two axes' weights) read once, the pooled bins
written once.  Its operations depend on the rois' sizes and are not
counted: the least time is the bytes', a bound that never overstates."""


def serve_bytes(b, h, w, c, r, p=7, itemsize=4):
    return itemsize * (b * h * w * c + b * r * 5 + b * r * p * p * c)


def train_bytes(b, h, w, c, r, p=7, itemsize=4):
    return itemsize * (b * h * w * c + b * r * p * (h + w)
                       + b * r * p * p * c)
