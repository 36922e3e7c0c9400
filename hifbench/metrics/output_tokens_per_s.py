"""Every token the window's calls generated, over the window's wall time."""


def read(record):
    tokens = sum(c["batch"] * c["new_tokens"] for c in record["calls"])
    return tokens / record["window_s"]
