"""peak_mem_gib: the most device memory the program held over set-up and
the window (torch.cuda.max_memory_allocated), the largest over the ranks,
in GiB; read before the reference runs."""


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec["platform"] == "gpu" else None
