"""The device memory peak over set-up and window (MiB):
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the run's start. Nothing to read off the card."""


def compute(rec):
    if not rec["peak_mem_bytes"]:
        return None
    return rec["peak_mem_bytes"] / float(1 << 20)
