"""The harness: cells, traffic, the program under test, traces, the judge."""
