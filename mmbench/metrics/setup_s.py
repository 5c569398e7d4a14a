"""Seconds from the process's start to the first timed window: loading the
port and its kernels, ``make_engine``, the restore, ``warmup()``, the
warm-up windows and the inputs."""


def read(rec):
    return rec.setup_s
