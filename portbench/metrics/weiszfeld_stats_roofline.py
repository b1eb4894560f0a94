"""``weiszfeld_stats``'s share of its roofline (%): the least time the card
could take for the work of the data's real rows and the real k, over the
device time under the program's ``work:weiszfeld_stats`` scopes, whatever kernel
serves the call."""


def read(ctx):
    return ctx.roofline("weiszfeld_stats")
