"""Every prompt token the window's calls prefilled, over its wall time."""


def read(record):
    tokens = sum(c["batch"] * c["prompt_len"] for c in record["calls"])
    return tokens / record["window_s"]
