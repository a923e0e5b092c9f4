"""Host syncs a call: the `.sync` spans (the program's mark on every call
that blocks the host until the card has run its queue) inside the cell's
outermost spans (`compaction.solve`, `sequence.solve`) over their count, in
the traced window that profiles the host."""

from portbench import spans


def read(run):
    outer = spans.calls(run)
    if outer is None:
        return None
    return len(spans.syncs(run, outer)) / len(outer)
