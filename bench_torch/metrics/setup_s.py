"""setup_s: host seconds from the process's start to the first timed
frame: importing torch, the CUDA context, loading (at a checkout's first
run building) the cell's library, the scene and textures made on the
device from the seed, and the warm batches."""

UNIT = "s"


def read(run):
    return run.setup_s
