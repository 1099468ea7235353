"""setup_s: process start to the first unit of the measured window (host
clock): imports, the process group, kernel builds on a first run, the
system and its PC where the mix keeps them, and the warm-up units."""


def read(rec):
    return rec["setup_s"]
