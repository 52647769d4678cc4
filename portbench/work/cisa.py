"""The CISA attention core (K1 on the card): G groups of Nq query tokens
attend S shots of Ns support tokens; q and k have D channels, v and the
output C, the unary term one a support token."""


def flops(g, nq, s, ns, d, c):
    """The two products a shot: scores Nq x Ns over D, probabilities times
    v over C."""
    return 2 * g * s * nq * ns * (d + c)


def nbytes(g, nq, s, ns, d, c, itemsize=4):
    """q, k, v and u read once, the shot mean written once."""
    return itemsize * (g * nq * d + g * s * ns * (d + c + 1) + g * nq * c)


def projections_flops(g, nq, s, ns, cin, d, ba_block=False):
    """The q, k and unary projections of a site (and the BA block's
    channel scores and weighted sum)."""
    f = 2 * g * nq * cin * d + 2 * g * s * ns * cin * (d + 1)
    if ba_block:
        f += 4 * g * s * ns * cin
    return f
