"""The held experts' load balance over the window: per MoE layer, the rows
of its busiest held expert over the mean rows of its held experts (the
program's device counters, read once after the window), averaged over the
MoE layers; 1.0 is an even load.  The busiest expert sets a grouped
product's pace."""


def read(record):
    rows = record.get("rows_per_expert")
    if not rows:
        return None
    ratios = [max(r) / (sum(r) / len(r)) for r in rows if sum(r)]
    return sum(ratios) / len(ratios) if ratios else None
