"""blend_prep_ms_per_frame: host milliseconds a frame in the port's span
``lncr.raster3d.prep`` (the blend prep: the per-frame draw order, the
projection, edges, binning and table of a batch, enqueued), over the
traced run's replay of the profiled batch (the blend system's ``work``),
with tracing on.  Layer: blend prep."""

UNIT = "ms"
SPAN = "lncr.raster3d.prep"


def read(run):
    replay = run.work.get("blend_replay")
    if not replay or SPAN not in replay["spans"]:
        return None
    return replay["spans"][SPAN]["ns"] / replay["frames"] / 1e6
