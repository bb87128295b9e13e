"""native.unarmor_parallelism.dec: the unarmor_batch workers' summed busy time over
the passes' wall, for the passes that start inside the decode calls: 1.0 is one
core's worth, the ceiling the workers a pass starts. Reads the pass log that
the pipeline fills while its stage timer is set; None for a program without
it."""


def read(rec):
    from frad_python_tpu_torch import native

    calls = [(c.t0, c.t1) for c in rec.calls_of(("decode",))]
    passes = [p for p in getattr(native.unarmor_batch, "passes", ())
              if any(t0 <= p.t0 < t1 for t0, t1 in calls)]
    wall = sum(p.t1 - p.t0 for p in passes)
    return sum(p.busy_s for p in passes) / wall if passes and wall > 0 else None
