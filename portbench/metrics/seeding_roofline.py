"""The D^z seeding assignment's share of its roofline (%): one centre per
site, ``work:min_dist_argmin[k=1]``, over the data's real rows."""


def read(ctx):
    return ctx.roofline("min_dist_argmin[k=1]")
