"""setup_s: process start to the window's first study, host clock."""


def read(record):
    return record["setup_s"]
