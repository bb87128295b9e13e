"""native.unarmor_us_per_frame.dec: the unarmor_batch workers' summed busy time per
frame, in microseconds, for the passes that start inside the decode calls: the
CPU a frame's CRC check, parity strip and Reed-Solomon repair cost, whatever
the workers. Reads the pass log that the pipeline fills while its stage timer
is set; None for a program without it."""


def read(rec):
    from frad_python_tpu_torch import native

    calls = [(c.t0, c.t1) for c in rec.calls_of(("decode",))]
    passes = [p for p in getattr(native.unarmor_batch, "passes", ())
              if any(t0 <= p.t0 < t1 for t0, t1 in calls)]
    frames = sum(p.frames for p in passes)
    return 1e6 * sum(p.busy_s for p in passes) / frames if frames else None
