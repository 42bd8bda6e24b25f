"""peak_mem_gb: torch.cuda.max_memory_allocated() over set-up and window, in GB."""


def read(record):
    return record["peak_bytes"] / 1e9 if record["peak_bytes"] else None
