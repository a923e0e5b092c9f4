"""The mean wall of the compacted LM stage (solver/compaction.py's second
stage, on the worst B/16 elements) per call, in ms: a span from the
driver's stage wrapper, with a synchronize on each side, in the traced
run's window without the profiler."""


def read(run):
    spans = run.plain.work.get("refine_s") if run.plain is not None else None
    return 1e3 * sum(spans) / len(spans) if spans else None
