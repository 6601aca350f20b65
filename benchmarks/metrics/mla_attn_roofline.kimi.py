"""MLA's K1 / K2 (the attention kernels instantiated at q.k 192, v 128)
least time over their device time, in %: the bound of each profiled
step's forward and backward in every layer (``work_kimi.mla_fwd_ms`` /
``mla_bwd_ms``, from the batch's masks) over the summed time of the
kernels named ``attention_*<..., 192, 128>``."""

MLA = "192, 128>"


def read(record):
    if not record.get("mla_bound_ms"):
        return None
    ev = record["trace"]
    lo, hi = ev["window"]
    spent = sum(d for name, s, d, cat in ev["device"]
                if cat == "kernel" and lo <= s < hi and "attention" in name
                and MLA in name) / 1e3
    return 100.0 * record["mla_bound_ms"] / spent if spent else None
