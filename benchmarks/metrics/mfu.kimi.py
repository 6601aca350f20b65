"""``mfu.train`` read in the Kimi-VL cell (its model FLOPs a sample from
``work_kimi.train_flop_per_sample``), where it moves
``loop_samples_per_s``."""

from benchmarks import harness


def read(record):
    return harness.metric_reader("mfu.train")(record)
